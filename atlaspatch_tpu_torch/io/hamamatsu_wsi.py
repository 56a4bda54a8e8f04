"""Hamamatsu .vms / .vmu slide backends.

The reference reads these through OpenSlide (reference:
atlas_patch/core/wsi/wsi_factory.py:20-39). First-party readers built from
the public format description (openslide.org/formats/hamamatsu):

VMS — an INI map file ([Virtual Microscope Specimen]) referencing a grid of
JPEG images (`ImageFile`, `ImageFile(x)`, `ImageFile(x,y)`; grid size
NoJpegColumns x NoJpegRows), plus MapFile / OptimisationFile / MacroImage.
Pyramid levels are derived the way OpenSlide derives them: libjpeg DCT-space
scaling at 1/1, 1/2, 1/4, 1/8. Tiles are decoded whole at the requested
scale and LRU-cached; restart-marker random access (OpenSlide's optimisation
for multi-gigapixel VMS JPEGs) is a possible future optimisation, not a
correctness requirement.

VMU — the uncompressed variant ([Uncompressed Virtual Microscope Specimen])
referencing NGR files: a binary header ("GN" magic; int32 width @4, height
@8, column width @12, pixel-data offset @24, little-endian), then 16-bit LE
RGB samples stored in column blocks (each block `column_width` wide, rows
consecutive within a block). Exposed as a single level; samples map to 8-bit
via the high byte.

Caveat: validated by round-trip tests on spec-conformant synthetic slides
(tests/container_builders.py); no vendor files exist in this offline
environment to cross-check.
"""

from __future__ import annotations

import configparser
import struct
from pathlib import Path
from threading import Lock
from typing import Any, Literal, Optional, Tuple, Union

import numpy as np
from atlaspatch_tpu_torch.io.iwsi import IWSI
from atlaspatch_tpu_torch.io.tiled import TiledLevel, thumb_from_level

VMS_SECTION = "Virtual Microscope Specimen"
VMU_SECTION = "Uncompressed Virtual Microscope Specimen"
_SCALES = (1, 2, 4, 8)


def _read_ini(path: Path) -> configparser.ConfigParser:
    cp = configparser.ConfigParser(interpolation=None, strict=False)
    cp.optionxform = str  # type: ignore[method-assign]
    try:
        with open(path, encoding="utf-8-sig") as f:
            cp.read_file(f)
    except (configparser.Error, UnicodeDecodeError, ValueError) as e:
        kind = "vmu" if path.suffix.lower() == ".vmu" else "vms"
        raise RuntimeError(f"{kind}: not a Hamamatsu map file: {e}") from e
    return cp


def _image_grid(cp: configparser.ConfigParser, section: str) -> dict[tuple[int, int], str]:
    """Map (col, row) -> file name from ImageFile / ImageFile(x) / ImageFile(x,y)."""
    grid: dict[tuple[int, int], str] = {}
    for key, val in cp.items(section):
        if key == "ImageFile":
            grid[(0, 0)] = val
        elif key.startswith("ImageFile(") and key.endswith(")"):
            parts = key[len("ImageFile(") : -1].split(",")
            try:
                nums = [int(p) for p in parts]
            except ValueError:
                continue
            if len(nums) == 1:
                grid[(nums[0], 0)] = val
            elif len(nums) == 2:
                grid[(nums[0], nums[1])] = val
            # 3-part keys address focal layers > 0; layer 0 uses the forms above.
    return grid


def _apply_mpp_mag(wsi: IWSI, meta: dict[str, Any], w0: int) -> None:
    """Shared VMS/VMU MPP + magnification ladder (PhysicalWidth → pitch → lens)."""
    if wsi._mpp_manual is not None:
        wsi.mpp = wsi.validate_mpp(wsi._mpp_manual, source="user-provided mpp")
    else:
        mpp = None
        phys_w = meta.get("hamamatsu.PhysicalWidth")  # nanometres
        if phys_w is not None and w0:
            try:
                mpp = round(float(phys_w) / 1000.0 / w0, 4)
            except (ValueError, ZeroDivisionError):
                mpp = None
        if mpp is None and meta.get("hamamatsu.PhysicalPitchX") is not None:
            try:
                mpp = round(float(meta["hamamatsu.PhysicalPitchX"]) / 1000.0, 4)
            except ValueError:
                mpp = None
        wsi.mpp = wsi.validate_mpp(mpp, source="slide metadata") if mpp is not None else None
    lens = meta.get("hamamatsu.SourceLens")
    if lens is not None:
        try:
            wsi.mag = int(float(lens))
        except ValueError:
            wsi.mag = None
    elif wsi.mpp is not None:
        try:
            wsi.mag = wsi._infer_mag(wsi.mpp)
        except ValueError:
            wsi.mag = None


class HamamatsuVMSWSI(IWSI):
    """Hamamatsu VMS (JPEG grid) backend."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._levels: list[TiledLevel] = []
        self._files: dict[tuple[int, int], Path] = {}
        # One-slot cache for the window-decode FALLBACK (native windowed
        # decode failed for a key): holds the one whole-decoded tile so the
        # N patch reads that cluster inside it cost one full decode, not N,
        # while memory stays bounded to a single tile.
        self._fallback_full: tuple[tuple[tuple[int, int], int], np.ndarray] | None = None
        self._fallback_lock = Lock()
        self._source_mmaps: dict[tuple[int, int], Any] = {}

    def _setup(self) -> None:
        vms = Path(self.path)
        cp = _read_ini(vms)
        if not cp.has_section(VMS_SECTION):
            raise RuntimeError(f"vms: missing [{VMS_SECTION}] section in {vms}")
        sec = cp[VMS_SECTION]
        cols = int(sec.get("NoJpegColumns", 1))
        rows = int(sec.get("NoJpegRows", 1))
        grid = _image_grid(cp, VMS_SECTION)
        if not grid:
            raise RuntimeError("vms: no ImageFile entries")
        self._files = {pos: vms.parent / name for pos, name in grid.items()}
        for (c, r), p in self._files.items():
            if not (0 <= c < cols and 0 <= r < rows):
                raise RuntimeError(f"vms: ImageFile({c},{r}) outside declared grid")
            if not p.exists():
                raise RuntimeError(f"vms: referenced image missing: {p}")

        from atlaspatch_tpu_torch.io.native import jpeg_image_info

        # Geometry probe: only the JPEG header (up to SOF) is needed; avoid
        # slurping multi-gigabyte VMS images just to size the grid.
        def probe(pos: tuple[int, int], scale: int) -> tuple[int, int]:
            p = self._files[pos]
            with p.open("rb") as f:
                head = f.read(1 << 20)
            try:
                return jpeg_image_info(head, scale)
            except RuntimeError:
                return jpeg_image_info(p.read_bytes(), scale)

        levels: list[TiledLevel] = []
        dims: list[tuple[int, int]] = []
        for scale in _SCALES:
            col_w = [0] * cols
            row_h = [0] * rows
            per_tile: dict[tuple[int, int], tuple[int, int]] = {}
            for pos in self._files:
                w, h = probe(pos, scale)
                per_tile[pos] = (w, h)
                col_w[pos[0]] = max(col_w[pos[0]], w)
                row_h[pos[1]] = max(row_h[pos[1]], h)
            x_off = np.concatenate([[0], np.cumsum(col_w)]).astype(int)
            y_off = np.concatenate([[0], np.cumsum(row_h)]).astype(int)
            tiles = [
                (int(x_off[c]), int(y_off[r]), w, h, ((c, r), scale))
                for (c, r), (w, h) in per_tile.items()
            ]
            lw, lh = int(x_off[cols]), int(y_off[rows])
            levels.append(
                TiledLevel(lw, lh, 1.0, tiles, self._decode_tile,
                           (255, 255, 255), cache_tiles=4,
                           decode_window=self._decode_tile_window)
            )
            dims.append((lw, lh))
        downs = [dims[0][0] / d[0] for d in dims]
        for level, ds in zip(levels, downs):
            level.downsample = ds

        self._levels = levels
        self.w, self.h = dims[0]
        self.nlvl = len(levels)
        self.dims = dims
        self.ds = downs

        meta: dict[str, Any] = {}
        for key in ("SourceLens", "PhysicalWidth", "PhysicalHeight", "NoLayers",
                    "MapFile", "MacroImage", "AuthCode"):
            if key in sec:
                meta[f"hamamatsu.{key}"] = sec[key]
        self.meta = meta
        _apply_mpp_mag(self, meta, self.w)

    def _decode_tile(self, key: tuple[tuple[int, int], int]) -> Optional[np.ndarray]:
        pos, scale = key
        from atlaspatch_tpu_torch.io.native import jpeg_decode

        return jpeg_decode(self._files[pos].read_bytes(), scale)

    def _decode_tile_window(
        self, key: tuple[tuple[int, int], int], x: int, y: int, w: int, h: int
    ) -> Optional[np.ndarray]:
        """Partial decode for large source JPEGs: only the window's MCU rows
        are entropy-decoded (libjpeg-turbo crop + skip), so multi-gigapixel
        VMS images never decode whole per patch read (the concern OpenSlide
        solves with its restart-marker optimisation file)."""
        pos, scale = key
        from atlaspatch_tpu_torch.io.native import jpeg_decode_window

        with self._fallback_lock:
            if self._fallback_full is not None and self._fallback_full[0] == key:
                return self._fallback_full[1][y : y + h, x : x + w]
        try:
            return jpeg_decode_window(self._source_map(pos), scale, x, y, w, h)
        except RuntimeError:
            # Fallback: decode whole ONCE (cached one-slot above — the
            # failure is deterministic per stream, and re-decoding a
            # multi-gigapixel JPEG per patch read would dominate the run)
            # and CROP to the requested window — the caller pastes the
            # return value at the window position, so returning the full
            # tile here would paste the wrong pixels.
            full = self._decode_tile(key)
            if full is None:
                return None
            with self._fallback_lock:
                self._fallback_full = (key, full)
            return full[y : y + h, x : x + w]

    # --- IWSI surface -----------------------------------------------------
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
        level = self._levels[lv]
        x = int(xy[0] / level.downsample)
        y = int(xy[1] / level.downsample)
        arr = level.read_region(x, y, int(wh[0]), int(wh[1]))
        if mode == "image":
            from PIL import Image

            return Image.fromarray(arr)
        if mode == "array":
            return arr
        raise ValueError(f"Invalid mode: {mode}")

    def get_size(self, lv: int = 0) -> Tuple[int, int]:
        self._ensure_loaded()
        if self.dims is None or lv < 0 or lv >= len(self.dims):
            raise IndexError(f"Level {lv} out of range")
        return self.dims[lv]

    def get_thumb(self, max_hw: Tuple[int, int]) -> "Image.Image":
        self._ensure_loaded()
        return thumb_from_level(self._levels[-1], max_hw)

    def _source_map(self, pos: tuple[int, int]):
        """mmap of a source JPEG, cached per grid position: windowed decodes
        touch only the header + the window's MCU rows, so paging beats
        re-reading the (potentially multi-GB) compressed stream per patch."""
        with self._fallback_lock:
            m = self._source_mmaps.get(pos)
            if m is None:
                import mmap

                with open(self._files[pos], "rb") as f:
                    m = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                self._source_mmaps[pos] = m
            return m

    def cleanup(self) -> None:
        for level in self._levels:
            level.clear_cache()
        with self._fallback_lock:
            self._fallback_full = None
            for m in self._source_mmaps.values():
                try:
                    m.close()
                except BufferError:
                    # a decode still holds a view; the map is freed when the
                    # last view drops (better a deferred unmap than a crash)
                    pass
            self._source_mmaps.clear()
        self._loaded = False


class _NgrFile:
    """Memory-mapped NGR (Hamamatsu uncompressed) pixel access."""

    def __init__(self, path: Path) -> None:
        header = path.read_bytes()[:28] if path.stat().st_size >= 28 else b""
        if len(header) < 28 or not header.startswith(b"GN"):
            raise RuntimeError(f"ngr: bad magic in {path}")
        self.w = struct.unpack_from("<i", header, 4)[0]
        self.h = struct.unpack_from("<i", header, 8)[0]
        self.column_width = struct.unpack_from("<i", header, 12)[0]
        self.data_offset = struct.unpack_from("<i", header, 24)[0]
        if self.w <= 0 or self.h <= 0 or self.column_width <= 0:
            raise RuntimeError(f"ngr: invalid dimensions in {path}")
        if self.w % self.column_width:
            raise RuntimeError("ngr: width not a multiple of the column width")
        n_blocks = self.w // self.column_width
        try:
            self._mm = np.memmap(
                path,
                dtype="<u2",
                mode="r",
                offset=self.data_offset,
                shape=(n_blocks, self.h, self.column_width, 3),
            )
        except (ValueError, OSError) as e:
            raise RuntimeError(f"ngr: truncated or invalid pixel data in {path}: {e}") from e

    def read_region(self, x: int, y: int, w: int, h: int) -> np.ndarray:
        out = np.full((h, w, 3), 255, dtype=np.uint8)
        x0, y0 = max(0, x), max(0, y)
        x1, y1 = min(self.w, x + w), min(self.h, y + h)
        if x0 >= x1 or y0 >= y1:
            return out
        cw = self.column_width
        for blk in range(x0 // cw, (x1 - 1) // cw + 1):
            bx0, bx1 = max(x0, blk * cw), min(x1, (blk + 1) * cw)
            span = self._mm[blk, y0:y1, bx0 - blk * cw : bx1 - blk * cw, :]
            out[y0 - y : y1 - y, bx0 - x : bx1 - x] = (span >> 8).astype(np.uint8)
        return out

    def read_decimated(self, step: int) -> np.ndarray:
        """Every step-th pixel of the whole image (cheap NGR thumbnail)."""
        ys = np.arange(0, self.h, step)
        xs = np.arange(0, self.w, step)
        out = np.empty((len(ys), len(xs), 3), dtype=np.uint8)
        cw = self.column_width
        for blk in range(self.w // cw):
            sel = (xs >= blk * cw) & (xs < (blk + 1) * cw)
            if not sel.any():
                continue
            cols = xs[sel] - blk * cw
            span = self._mm[blk][np.ix_(ys, cols)]
            out[:, sel] = (span >> 8).astype(np.uint8)
        return out

    def close(self) -> None:
        self._mm = None  # releases the mmap


class HamamatsuVMUWSI(IWSI):
    """Hamamatsu VMU (uncompressed NGR) backend — single-level pyramid."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._ngr: Optional[_NgrFile] = None

    def _setup(self) -> None:
        vmu = Path(self.path)
        cp = _read_ini(vmu)
        if not cp.has_section(VMU_SECTION):
            raise RuntimeError(f"vmu: missing [{VMU_SECTION}] section in {vmu}")
        sec = cp[VMU_SECTION]
        grid = _image_grid(cp, VMU_SECTION)
        if (0, 0) not in grid:
            raise RuntimeError("vmu: no ImageFile entry")
        if len(grid) > 1:
            raise RuntimeError("vmu: multi-file VMU grids are not supported")
        self._ngr = _NgrFile(vmu.parent / grid[(0, 0)])

        self.w, self.h = self._ngr.w, self._ngr.h
        self.nlvl = 1
        self.dims = [(self.w, self.h)]
        self.ds = [1.0]
        meta: dict[str, Any] = {}
        for key in ("SourceLens", "PhysicalWidth", "PhysicalHeight",
                    "PhysicalPitchX", "PhysicalPitchY", "NoLayers", "MapFile"):
            if key in sec:
                meta[f"hamamatsu.{key}"] = sec[key]
        self.meta = meta
        _apply_mpp_mag(self, meta, self.w)

    def extract(
        self,
        xy: Tuple[int, int],
        lv: int,
        wh: Tuple[int, int],
        *,
        mode: Literal["array", "image"] = "array",
    ) -> Union[np.ndarray, "Image.Image"]:
        self._ensure_loaded()
        assert self._ngr is not None
        if lv != 0:
            raise IndexError(f"Level {lv} out of range")
        arr = self._ngr.read_region(int(xy[0]), int(xy[1]), int(wh[0]), int(wh[1]))
        if mode == "image":
            from PIL import Image

            return Image.fromarray(arr)
        if mode == "array":
            return arr
        raise ValueError(f"Invalid mode: {mode}")

    def get_size(self, lv: int = 0) -> Tuple[int, int]:
        self._ensure_loaded()
        if lv != 0:
            raise IndexError(f"Level {lv} out of range")
        return (self.w, self.h)  # type: ignore[return-value]

    def get_thumb(self, max_hw: Tuple[int, int]) -> "Image.Image":
        self._ensure_loaded()
        assert self._ngr is not None
        # Strided decimation straight off the memmap (touches only the
        # sampled pages), then PIL finishes the fit.
        step = max(1, max(self.w // max_hw[0], self.h // max_hw[1]))  # type: ignore[operator]
        arr = self._ngr.read_decimated(step)
        from PIL import Image

        img = Image.fromarray(arr)
        img.thumbnail(max_hw, Image.Resampling.LANCZOS)
        return img.convert("RGB")

    def cleanup(self) -> None:
        if self._ngr is not None:
            self._ngr.close()
            self._ngr = None
        self._loaded = False
