"""MIRAX (3DHISTECH) .mrxs slide backend.

The reference reads MIRAX through OpenSlide (reference:
atlas_patch/core/wsi/wsi_factory.py:20-39). This is a first-party reader
built from the public format description (openslide.org/formats/mirax):

  <name>.mrxs                 marker file (ignored beyond existence)
  <name>/Slidedat.ini         container metadata (INI)
  <name>/<INDEXFILE>          binary tile index (Index.dat)
  <name>/Data####.dat         concatenated tile payloads (JPEG/PNG/BMP)

Index.dat layout used here (little-endian throughout):
  bytes [0:5)                 version string
  bytes [5:5+len(SLIDE_ID))   slide id (must match Slidedat.ini)
  int32 hier_root             offset of the hierarchical pointer table
  int32 nonhier_root          offset of the non-hierarchical pointer table
  * hier table: one int32 pointer per hierarchical record (zoom level);
    the pointer resolves to an int32 that points at the first data page.
  * data page: int32 entry_count, int32 next_page (0 = last), then
    entry_count entries of 4x int32: (image_index, offset, length, fileno).
    image_index addresses the level-0 camera grid row-major
    (y * IMAGENUMBER_X + x).
  * nonhier records use the same page layout; the first entry's
    (offset, length, fileno) locates the payload (image_index unused).

Camera positioning: VIMSLIDE_POSITION_BUFFER (9 bytes per camera: uint8
present flag, int32 x, int32 y in level-0 pixels; optionally zlib-deflated)
when present; otherwise the regular grid pitch (DIGITIZER_WIDTH - OVERLAP_X).
Zoom level k concatenates IMAGE_CONCAT_FACTOR cameras per side, so a tile's
level-k position is its top-left camera position / concat.

Caveat: written to the published description and validated by round-trip
tests on spec-conformant synthetic slides (tests/container_builders.py); no
vendor-produced .mrxs files exist in this offline environment to cross-check.
"""

from __future__ import annotations

import configparser
import math
import os
import struct
import zlib
from threading import Lock
from pathlib import Path
from typing import Any, Literal, Optional, Tuple, Union

import numpy as np
from atlaspatch_tpu_torch.io.iwsi import IWSI
from atlaspatch_tpu_torch.io.tiled import TiledLevel, thumb_from_level

ZOOM_HIER_NAME = "Slide zoom level"
POSITION_BUFFER_NAME = "VIMSLIDE_POSITION_BUFFER"


def _u32(buf: bytes, off: int) -> int:
    if not 0 <= off <= len(buf) - 4:
        raise RuntimeError("mirax: pointer outside Index.dat")
    return struct.unpack_from("<i", buf, off)[0]


class _SlideDat:
    """Parsed Slidedat.ini with typed accessors."""

    def __init__(self, path: Path) -> None:
        cp = configparser.ConfigParser(interpolation=None, strict=False)
        cp.optionxform = str  # type: ignore[method-assign]  # keys are case-sensitive
        try:
            with open(path, encoding="utf-8-sig") as f:
                cp.read_file(f)
        except (configparser.Error, UnicodeDecodeError, ValueError) as e:
            raise RuntimeError(f"mirax: cannot parse Slidedat.ini: {e}") from e
        self.cp = cp

    def get(self, section: str, key: str, default: Any = None) -> Any:
        try:
            return self.cp.get(section, key)
        except (configparser.NoSectionError, configparser.NoOptionError):
            return default

    def require(self, section: str, key: str) -> str:
        val = self.get(section, key)
        if val is None:
            raise ValueError(f"Slidedat.ini missing [{section}] {key}")
        return val


def _read_pages(index: bytes, first_page: int) -> list[tuple[int, int, int, int]]:
    """Walk a data-page chain; returns (image_index, offset, length, fileno).

    Corrupt indexes must fail cleanly: page pointers are bounds-checked and a
    cyclic next-page chain is detected instead of looping forever."""
    entries: list[tuple[int, int, int, int]] = []
    page = first_page
    seen: set[int] = set()
    while page:
        if page in seen:
            raise RuntimeError("mirax: cyclic data-page chain in Index.dat")
        seen.add(page)
        if not 0 <= page <= len(index) - 8:
            raise RuntimeError("mirax: data-page pointer outside Index.dat")
        n, nxt = struct.unpack_from("<ii", index, page)
        if n < 0 or page + 8 + 16 * n > len(index):
            raise RuntimeError("mirax: data page overruns Index.dat")
        off = page + 8
        for _ in range(n):
            entries.append(struct.unpack_from("<iiii", index, off))
            off += 16
        page = nxt
    return entries


class MiraxWSI(IWSI):
    """Pyramidal access to a MIRAX virtual slide."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._levels: list[TiledLevel] = []
        self._datafiles: list[Path] = []
        self._data_handles: dict[int, Any] = {}
        self._handles_lock = Lock()

    # --- container parsing -------------------------------------------------
    def _setup(self) -> None:
        mrxs = Path(self.path)
        data_dir = mrxs.with_suffix("")
        if not data_dir.is_dir():
            raise RuntimeError(f"mirax: data directory not found: {data_dir}")
        ini_path = data_dir / "Slidedat.ini"
        if not ini_path.exists():
            raise RuntimeError(f"mirax: Slidedat.ini not found in {data_dir}")
        dat = _SlideDat(ini_path)

        slide_id = dat.require("GENERAL", "SLIDE_ID")
        grid_x = int(dat.require("GENERAL", "IMAGENUMBER_X"))
        grid_y = int(dat.require("GENERAL", "IMAGENUMBER_Y"))
        index_name = dat.get("HIERARCHICAL", "INDEXFILE", "Index.dat")

        nfiles = int(dat.require("DATAFILE", "FILE_COUNT"))
        self._datafiles = [data_dir / dat.require("DATAFILE", f"FILE_{i}") for i in range(nfiles)]

        # Hierarchical layout: locate the zoom hierarchy and flat record ids.
        hier_count = int(dat.require("HIERARCHICAL", "HIER_COUNT"))
        zoom_hier = None
        rec_base = 0
        for i in range(hier_count):
            cnt = int(dat.require("HIERARCHICAL", f"HIER_{i}_COUNT"))
            if dat.get("HIERARCHICAL", f"HIER_{i}_NAME") == ZOOM_HIER_NAME:
                zoom_hier = (i, rec_base, cnt)
            rec_base += cnt
        if zoom_hier is None:
            if hier_count < 1:
                raise RuntimeError("mirax: no hierarchies declared")
            zoom_hier = (0, 0, int(dat.require("HIERARCHICAL", "HIER_0_COUNT")))
        zoom_i, zoom_rec_base, n_zoom = zoom_hier
        total_hier_records = rec_base

        # Non-hierarchical layout: find the camera position buffer if present.
        nonhier_count = int(dat.get("HIERARCHICAL", "NONHIER_COUNT", 0))
        pos_rec = None
        nh_base = 0
        for i in range(nonhier_count):
            cnt = int(dat.require("HIERARCHICAL", f"NONHIER_{i}_COUNT"))
            if dat.get("HIERARCHICAL", f"NONHIER_{i}_NAME") == POSITION_BUFFER_NAME:
                pos_rec = nh_base
            nh_base += cnt

        index = (data_dir / index_name).read_bytes()
        version = index[:5].decode(errors="replace")
        got_id = index[5 : 5 + len(slide_id)].decode(errors="replace")
        if got_id != slide_id:
            raise RuntimeError(
                f"mirax: Index.dat slide id mismatch (ini {slide_id!r}, index {got_id!r})"
            )
        roots_off = 5 + len(slide_id)
        hier_root, nonhier_root = struct.unpack_from("<ii", index, roots_off)

        def record_entries(root: int, recno: int) -> list[tuple[int, int, int, int]]:
            ptr = _u32(index, root + 4 * recno)
            if ptr == 0:
                return []
            return _read_pages(index, _u32(index, ptr))

        # Camera positions (level-0 pixels).
        sec0 = dat.require("HIERARCHICAL", f"HIER_{zoom_i}_VAL_0_SECTION")
        tw0 = int(dat.require(sec0, "DIGITIZER_WIDTH"))
        th0 = int(dat.require(sec0, "DIGITIZER_HEIGHT"))
        if tw0 <= 0 or th0 <= 0:
            raise RuntimeError("mirax: non-positive digitizer tile size")
        ox0 = float(dat.get(sec0, "OVERLAP_X", 0.0))
        oy0 = float(dat.get(sec0, "OVERLAP_Y", 0.0))
        # Overlaps only ever shrink the camera pitch; junk values (negative,
        # or >= the tile size — which would make the pitch non-positive) fall
        # back to zero overlap rather than producing degenerate extents.
        if not 0.0 <= ox0 < tw0:
            ox0 = 0.0
        if not 0.0 <= oy0 < th0:
            oy0 = 0.0
        positions: dict[int, tuple[int, int]] = {}
        # A camera can sit anywhere inside the abutting-grid extent (overlaps
        # only pull it inward); positions beyond that are corrupt-buffer junk
        # — an int32 of 2^31 here would declare a terabyte-scale level. Such
        # cameras fall back to their regular grid pitch (cam_pos below).
        max_px, max_py = grid_x * tw0, grid_y * th0
        if pos_rec is not None and nonhier_root:
            entries = record_entries(nonhier_root, pos_rec)
            if entries:
                _, off, length, fileno = entries[0]
                raw = self._read_payload(fileno, off, length)
                if len(raw) != 9 * grid_x * grid_y:
                    raw = zlib.decompress(raw)
                for cam in range(grid_x * grid_y):
                    flag = raw[cam * 9]
                    px, py = struct.unpack_from("<ii", raw, cam * 9 + 1)
                    if flag and 0 <= px <= max_px and 0 <= py <= max_py:
                        positions[cam] = (px, py)

        def cam_pos(cx: int, cy: int) -> tuple[int, int]:
            p = positions.get(cy * grid_x + cx)
            if p is not None:
                return p
            return (int(round(cx * (tw0 - ox0))), int(round(cy * (th0 - oy0))))

        # Level-0 extent from the camera grid.
        if positions:
            w0 = max(px + tw0 for px, _ in positions.values())
            h0 = max(py + th0 for _, py in positions.values())
        else:
            w0 = int(round((grid_x - 1) * (tw0 - ox0))) + tw0
            h0 = int(round((grid_y - 1) * (th0 - oy0))) + th0

        meta: dict[str, Any] = {
            "mirax.SLIDE_ID": slide_id,
            "mirax.version": version,
            "mirax.IMAGENUMBER_X": str(grid_x),
            "mirax.IMAGENUMBER_Y": str(grid_y),
        }
        for key in ("SLIDE_NAME", "PROJECT_NAME", "OBJECTIVE_MAGNIFICATION", "SLIDE_TYPE"):
            val = dat.get("GENERAL", key)
            if val is not None:
                meta[f"mirax.{key}"] = str(val)

        levels: list[TiledLevel] = []
        dims: list[tuple[int, int]] = []
        downs: list[float] = []
        for k in range(n_zoom):
            sec = dat.require("HIERARCHICAL", f"HIER_{zoom_i}_VAL_{k}_SECTION")
            tw = int(dat.require(sec, "DIGITIZER_WIDTH"))
            th = int(dat.require(sec, "DIGITIZER_HEIGHT"))
            concat = int(dat.get(sec, "IMAGE_CONCAT_FACTOR", 2**k if k else 1))
            if concat < 1:  # corrupt: a non-positive factor degenerates dims
                concat = 2**k if k else 1
            img_format = str(dat.get(sec, "IMAGE_FORMAT", "JPEG")).upper()
            # Packed BGR per the key name: B in the high byte, R in the low.
            fill = int(dat.get(sec, "IMAGE_FILL_COLOR_BGR", 0xFFFFFF))
            fill_rgb = (fill & 0xFF, (fill >> 8) & 0xFF, (fill >> 16) & 0xFF)
            lw = max(1, math.ceil(w0 / concat))
            lh = max(1, math.ceil(h0 / concat))

            entries = record_entries(hier_root, zoom_rec_base + k)
            tiles = []
            for image_index, off, length, fileno in entries:
                cx, cy = image_index % grid_x, image_index // grid_x
                px, py = cam_pos(cx, cy)
                tiles.append((px // concat, py // concat, tw, th, (fileno, off, length, img_format)))
            levels.append(
                TiledLevel(lw, lh, float(concat), tiles, self._decode_tile, fill_rgb)
            )
            dims.append((lw, lh))
            downs.append(float(concat))
            if k == 0:
                mpp_x = dat.get(sec, "MICROMETER_PER_PIXEL_X")
                if mpp_x is not None:
                    meta["mirax.MICROMETER_PER_PIXEL_X"] = str(mpp_x)

        self._levels = levels
        self.w, self.h = w0, h0
        self.nlvl = len(levels)
        self.dims = dims
        self.ds = downs
        self.meta = meta

        if self._mpp_manual is not None:
            self.mpp = self.validate_mpp(self._mpp_manual, source="user-provided mpp")
        else:
            raw_mpp = meta.get("mirax.MICROMETER_PER_PIXEL_X")
            self.mpp = (
                self.validate_mpp(round(float(raw_mpp), 4), source="slide metadata")
                if raw_mpp is not None
                else None
            )
        mag = meta.get("mirax.OBJECTIVE_MAGNIFICATION")
        if mag is not None:
            self.mag = int(float(mag))
        elif self.mpp is not None:
            try:
                self.mag = self._infer_mag(self.mpp)
            except ValueError:
                self.mag = None

    # --- tile payloads -------------------------------------------------------
    def _read_payload(self, fileno: int, offset: int, length: int) -> bytes:
        if not 0 <= fileno < len(self._datafiles):
            raise RuntimeError(f"mirax: entry references unknown data file {fileno}")
        # os.pread: positional, thread-safe — patch reads fan out over a
        # thread pool on ONE WSI instance, and interleaved seek()+read() on a
        # shared handle would return bytes at another thread's offset.
        fh = self._data_handles.get(fileno)
        if fh is None:
            with self._handles_lock:
                fh = self._data_handles.get(fileno)
                if fh is None:
                    fh = open(self._datafiles[fileno], "rb")
                    self._data_handles[fileno] = fh
        data = os.pread(fh.fileno(), length, offset)
        if len(data) != length:
            raise RuntimeError("mirax: truncated tile payload")
        return data

    def _decode_tile(self, key: tuple[int, int, int, str]) -> Optional[np.ndarray]:
        fileno, offset, length, img_format = key
        data = self._read_payload(fileno, offset, length)
        if img_format == "JPEG":
            from atlaspatch_tpu_torch.io.native import jpeg_decode

            return jpeg_decode(data)
        # PNG / BMP tiles occur in some MIRAX versions.
        import io as _io

        from PIL import Image

        with Image.open(_io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))

    # --- IWSI surface ---------------------------------------------------------
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

    def cleanup(self) -> None:
        for fh in self._data_handles.values():
            try:
                fh.close()
            except Exception:
                pass
        self._data_handles.clear()
        for level in self._levels:
            level.clear_cache()
        self._loaded = False

    def __del__(self) -> None:
        try:
            self.cleanup()
        except Exception:
            pass
