"""DICOM whole-slide imaging (.dcm) backend.

The reference reads DICOM WSI through OpenSlide (reference:
atlas_patch/core/wsi/wsi_factory.py:20-39). This is a first-party reader for
the VL Whole Slide Microscopy Image IOD (DICOM PS3.3 A.32.8) built directly
on the Part-10 encoding rules — no pydicom in this environment:

* Part-10 file: 128-byte preamble, "DICM", explicit-VR-LE file meta group
  (gives TransferSyntaxUID), then the dataset.
* Dataset parsing: explicit and implicit VR little endian, with recursive
  sequence (SQ) support for both defined- and undefined-length items.
* Pixel data: native (uncompressed interleaved 8-bit) frames, or
  encapsulated fragments for JPEG baseline (1.2.840.10008.1.2.4.50) and
  JPEG2000 (.4.90/.4.91), decoded by the native library
  (io/native.py: jpeg_decode / j2k_decode_rgb).
* Tile layout: TILED_FULL row-major frame order, or TILED_SPARSE via the
  per-frame functional groups' PlanePositionSlide coordinates.
* Pyramid assembly: a .dcm path is one level; sibling .dcm files in the same
  directory with the same SeriesInstanceUID (LABEL/OVERVIEW/THUMBNAIL
  instances excluded) are collected and sorted into the level stack — the
  same directory convention OpenSlide uses.

MPP comes from SharedFunctionalGroupsSequence → PixelMeasuresSequence →
PixelSpacing (mm) with a top-level PixelSpacing fallback; objective power
from OpticalPathSequence → ObjectiveLensPower.
"""

from __future__ import annotations

import mmap
import struct
from pathlib import Path
from typing import Any, Literal, Optional, Tuple, Union

import numpy as np
from atlaspatch_tpu_torch.io.iwsi import IWSI
from atlaspatch_tpu_torch.io.tiled import TiledLevel, thumb_from_level

# --- transfer syntaxes ----------------------------------------------------
TS_IMPLICIT_LE = "1.2.840.10008.1.2"
TS_EXPLICIT_LE = "1.2.840.10008.1.2.1"
TS_JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
TS_J2K_LOSSLESS = "1.2.840.10008.1.2.4.90"
TS_J2K = "1.2.840.10008.1.2.4.91"
_SUPPORTED_TS = {TS_IMPLICIT_LE, TS_EXPLICIT_LE, TS_JPEG_BASELINE, TS_J2K_LOSSLESS, TS_J2K}

SOP_CLASS_WSI = "1.2.840.10008.5.1.4.1.1.77.1.6"

# Tags (group, element)
TAG_IMAGE_TYPE = (0x0008, 0x0008)
TAG_SOP_CLASS = (0x0008, 0x0016)
TAG_SERIES_UID = (0x0020, 0x000E)
TAG_DIM_ORG_TYPE = (0x0020, 0x9311)
TAG_SAMPLES_PER_PIXEL = (0x0028, 0x0002)
TAG_PHOTOMETRIC = (0x0028, 0x0004)
TAG_NUMBER_OF_FRAMES = (0x0028, 0x0008)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLUMNS = (0x0028, 0x0011)
TAG_BITS_ALLOCATED = (0x0028, 0x0100)
TAG_PIXEL_SPACING = (0x0028, 0x0030)
TAG_PIXEL_MEASURES_SQ = (0x0028, 0x9110)
TAG_TOTAL_COLS = (0x0048, 0x0006)
TAG_TOTAL_ROWS = (0x0048, 0x0007)
TAG_OPTICAL_PATH_SQ = (0x0048, 0x0105)
TAG_OBJECTIVE_POWER = (0x0048, 0x0112)
TAG_PLANE_POSITION_SQ = (0x0048, 0x021A)
TAG_COL_POSITION = (0x0048, 0x021E)
TAG_ROW_POSITION = (0x0048, 0x021F)
TAG_SHARED_FG_SQ = (0x5200, 0x9229)
TAG_PER_FRAME_FG_SQ = (0x5200, 0x9230)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)
TAG_ITEM = (0xFFFE, 0xE000)
TAG_ITEM_DELIM = (0xFFFE, 0xE00D)
TAG_SEQ_DELIM = (0xFFFE, 0xE0DD)

# Explicit-VR codes with a 4-byte length (and 2 reserved bytes)
_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR", b"UT", b"UN"}
# VRs we must treat as sequences under implicit VR
_IMPLICIT_SQ_TAGS = {
    TAG_SHARED_FG_SQ,
    TAG_PER_FRAME_FG_SQ,
    TAG_PIXEL_MEASURES_SQ,
    TAG_OPTICAL_PATH_SQ,
    TAG_PLANE_POSITION_SQ,
}
_US_TAGS = {TAG_ROWS, TAG_COLUMNS, TAG_SAMPLES_PER_PIXEL, TAG_BITS_ALLOCATED}
_UL_TAGS = {TAG_TOTAL_COLS, TAG_TOTAL_ROWS}
# SL-typed tags we consume (frame matrix positions) — needed so implicit-VR
# LE datasets (1.2.840.10008.1.2, in _SUPPORTED_TS) decode TILED_SPARSE.
_SL_TAGS = {(0x0048, 0x021E), (0x0048, 0x021F)}


class _DicomError(RuntimeError):
    pass


class _Dataset(dict):
    """tag -> decoded value; SQ values are lists of _Dataset."""

    def str_val(self, tag: tuple[int, int]) -> Optional[str]:
        v = self.get(tag)
        if v is None:
            return None
        if isinstance(v, bytes):
            return v.decode("ascii", errors="replace").strip("\x00 ")
        return str(v)

    def int_val(self, tag: tuple[int, int]) -> Optional[int]:
        v = self.get(tag)
        if v is None:
            return None
        if isinstance(v, int):
            return v
        s = self.str_val(tag)
        try:
            return int(float(s)) if s else None
        except ValueError:
            return None


def _decode_value(tag: tuple[int, int], vr: bytes, raw: bytes) -> Any:
    if vr == b"US" or (vr == b"??" and tag in _US_TAGS):
        return struct.unpack("<H", raw[:2])[0] if len(raw) >= 2 else None
    if vr == b"UL" or (vr == b"??" and tag in _UL_TAGS):
        return struct.unpack("<I", raw[:4])[0] if len(raw) >= 4 else None
    if vr == b"SL" or (vr == b"??" and tag in _SL_TAGS):
        return struct.unpack("<i", raw[:4])[0] if len(raw) >= 4 else None
    return raw


class _Parser:
    """One pass over a Part-10 file; pixel data recorded as (offset, length)
    spans, never copied."""

    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.ts = TS_EXPLICIT_LE

    def parse(self) -> tuple[_Dataset, Optional[dict]]:
        buf = self.buf
        if len(buf) < 132 + 8 or buf[128:132] != b"DICM":
            raise _DicomError("not a DICOM Part-10 file (no DICM magic)")
        pos = 132
        # File meta group is always explicit VR LE.
        meta_end = len(buf)
        ds = _Dataset()
        pixel_info: Optional[dict] = None
        explicit = True
        while pos < len(buf):
            if pos + 8 > len(buf):
                break
            group, elem = struct.unpack_from("<HH", buf, pos)
            tag = (group, elem)
            if pos >= meta_end and group == 0x0002:
                pass  # stray meta tag; parse as-is
            if group != 0x0002 and meta_end == len(buf):
                # First non-meta tag: lock in the dataset transfer syntax.
                meta_end = pos
                ts = ds.str_val((0x0002, 0x0010)) or TS_EXPLICIT_LE
                if ts not in _SUPPORTED_TS:
                    raise _DicomError(f"unsupported DICOM transfer syntax {ts}")
                self.ts = ts
                explicit = ts != TS_IMPLICIT_LE
            tag_explicit = explicit or group == 0x0002
            pos, value, vr, vl, data_off = self._read_element(pos, tag_explicit, tag)
            if tag == TAG_PIXEL_DATA:
                pixel_info = value  # dict from _read_pixel_data
                break  # pixel data is last in WSI objects
            ds[tag] = value
        return ds, pixel_info

    # Returns (new_pos, value, vr, length, data_offset)
    def _read_element(self, pos: int, explicit: bool, tag: tuple[int, int]):
        buf = self.buf
        group, elem = tag
        if explicit:
            vr = buf[pos + 4 : pos + 6]
            if vr in _LONG_VRS:
                (vl,) = struct.unpack_from("<I", buf, pos + 8)
                data_off = pos + 12
            else:
                (vl,) = struct.unpack_from("<H", buf, pos + 6)
                data_off = pos + 8
        else:
            vr = b"SQ" if tag in _IMPLICIT_SQ_TAGS else b"??"
            (vl,) = struct.unpack_from("<I", buf, pos + 4)
            data_off = pos + 8

        if tag == TAG_PIXEL_DATA:
            return data_off + (0 if vl == 0xFFFFFFFF else vl), self._read_pixel_data(
                data_off, vl
            ), vr, vl, data_off

        if vr == b"SQ" or (vl == 0xFFFFFFFF and vr in (b"??", b"UN")):
            items, end = self._read_sequence(data_off, vl, explicit)
            return end, items, b"SQ", vl, data_off

        if vl == 0xFFFFFFFF:
            raise _DicomError(f"undefined length on non-sequence tag {tag}")
        raw = bytes(buf[data_off : data_off + vl])
        return data_off + vl, _decode_value(tag, vr, raw), vr, vl, data_off

    def _read_sequence(self, pos: int, vl: int, explicit: bool):
        buf = self.buf
        end = pos + vl if vl != 0xFFFFFFFF else len(buf)
        items: list[_Dataset] = []
        while pos + 8 <= end:
            group, elem = struct.unpack_from("<HH", buf, pos)
            (ilen,) = struct.unpack_from("<I", buf, pos + 4)
            pos += 8
            if (group, elem) == TAG_SEQ_DELIM:
                break
            if (group, elem) != TAG_ITEM:
                raise _DicomError("malformed sequence (expected Item tag)")
            item_end = pos + ilen if ilen != 0xFFFFFFFF else end
            item = _Dataset()
            while pos + 8 <= item_end:
                g2, e2 = struct.unpack_from("<HH", buf, pos)
                if (g2, e2) == TAG_ITEM_DELIM:
                    pos += 8
                    break
                pos, value, _vr, _vl, _off = self._read_element(pos, explicit, (g2, e2))
                item[(g2, e2)] = value
            else:
                pos = item_end if ilen != 0xFFFFFFFF else pos
            items.append(item)
            if vl != 0xFFFFFFFF and pos >= end:
                break
        else:
            pos = end
        return items, (pos if vl == 0xFFFFFFFF else end)

    def _read_pixel_data(self, pos: int, vl: int) -> dict:
        buf = self.buf
        if vl != 0xFFFFFFFF:  # native
            return {"encapsulated": False, "offset": pos, "length": vl}
        fragments: list[tuple[int, int]] = []
        bot: list[int] = []
        first = True
        while pos + 8 <= len(buf):
            group, elem = struct.unpack_from("<HH", buf, pos)
            (ilen,) = struct.unpack_from("<I", buf, pos + 4)
            pos += 8
            if (group, elem) == TAG_SEQ_DELIM:
                break
            if (group, elem) != TAG_ITEM:
                raise _DicomError("malformed encapsulated pixel data")
            if first:
                # Basic Offset Table (may be empty)
                bot = list(struct.unpack_from(f"<{ilen // 4}I", buf, pos)) if ilen else []
                first = False
            else:
                fragments.append((pos, ilen))
            pos += ilen
        return {"encapsulated": True, "fragments": fragments, "bot": bot}


class _DicomLevel:
    """Parsed per-instance (= per pyramid level) state."""

    def __init__(self, path: Path) -> None:
        self.path = path
        # mmap, not read_bytes(): real WSI levels are multi-GB. The parser
        # walks element headers and records pixel data as (offset, length)
        # spans, so only header pages fault in here; decode_frame later
        # copies just one frame's span. (OpenSlide streams the same way.)
        self._f = open(path, "rb")
        try:
            buf = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError) as e:  # empty or unmappable file
            self._f.close()
            raise _DicomError(f"{path.name}: cannot map file: {e}") from e
        self.buf: Any = buf
        # Any failure past this point must release the mmap + fd: the sibling
        # scan in DicomWSI._setup probes every .dcm in the directory and
        # swallows errors, so a leak here accumulates one fd per non-WSI file.
        try:
            parser = _Parser(buf)
            try:
                self.ds, self.pixel = parser.parse()
            except (struct.error, IndexError, ValueError, MemoryError) as e:
                raise _DicomError(f"{path.name}: malformed DICOM dataset: {e}") from e
            self.ts = parser.ts
            ds = self.ds
            self.rows = ds.int_val(TAG_ROWS) or 0
            self.cols = ds.int_val(TAG_COLUMNS) or 0
            self.total_cols = ds.int_val(TAG_TOTAL_COLS) or self.cols
            self.total_rows = ds.int_val(TAG_TOTAL_ROWS) or self.rows
            self.n_frames = ds.int_val(TAG_NUMBER_OF_FRAMES) or 1
            self.spp = ds.int_val(TAG_SAMPLES_PER_PIXEL) or 3
            self.bits = ds.int_val(TAG_BITS_ALLOCATED) or 8
            self.photometric = (ds.str_val(TAG_PHOTOMETRIC) or "RGB").upper()
            self.series_uid = ds.str_val(TAG_SERIES_UID)
            self.image_type = (ds.str_val(TAG_IMAGE_TYPE) or "").upper()
            self.dim_org = (ds.str_val(TAG_DIM_ORG_TYPE) or "TILED_FULL").upper()
            if self.rows <= 0 or self.cols <= 0:
                raise _DicomError(f"{path.name}: missing Rows/Columns")
            if self.bits != 8:
                raise _DicomError(
                    f"{path.name}: only 8-bit samples supported (got {self.bits})"
                )
            if self.pixel is None:
                raise _DicomError(f"{path.name}: no PixelData")
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Release the mmap and file handle (idempotent)."""
        buf = getattr(self, "buf", None)
        if buf is not None:
            try:
                buf.close()
            except (BufferError, ValueError):
                pass  # live frame views keep the map alive until GC
            self.buf = None
        f = getattr(self, "_f", None)
        if f is not None:
            f.close()
            self._f = None

    def frame_positions(self) -> list[tuple[int, int]]:
        """Top-left pixel position of each frame in the total pixel matrix."""
        if self.dim_org == "TILED_FULL" or TAG_PER_FRAME_FG_SQ not in self.ds:
            across = max(1, -(-self.total_cols // self.cols))
            return [
                ((i % across) * self.cols, (i // across) * self.rows)
                for i in range(self.n_frames)
            ]
        positions: list[tuple[int, int]] = []
        for item in self.ds[TAG_PER_FRAME_FG_SQ]:
            plane_items = item.get(TAG_PLANE_POSITION_SQ) or []
            if not plane_items:
                raise _DicomError("TILED_SPARSE frame without PlanePositionSlideSequence")
            plane = plane_items[0]
            col = plane.int_val(TAG_COL_POSITION)
            row = plane.int_val(TAG_ROW_POSITION)
            if col is None or row is None:
                raise _DicomError("TILED_SPARSE frame without matrix position")
            positions.append((col - 1, row - 1))  # 1-based in DICOM
        if len(positions) != self.n_frames:
            raise _DicomError("per-frame functional groups do not cover all frames")
        return positions

    def frame_span(self, i: int) -> tuple[int, int]:
        """(offset, length) of frame i's encoded bytes within the file."""
        pix = self.pixel
        assert pix is not None
        if not pix["encapsulated"]:
            fsize = self.rows * self.cols * self.spp
            return (pix["offset"] + i * fsize, fsize)
        frags: list[tuple[int, int]] = pix["fragments"]
        if len(frags) == self.n_frames:
            return frags[i]
        bot = pix["bot"]
        if len(bot) == self.n_frames and frags:
            # BOT offsets are relative to the first byte of the first fragment
            # item header; group fragments per frame.
            base = frags[0][0] - 8
            starts = [base + off for off in bot]
            try:
                lo = next(k for k, f in enumerate(frags) if f[0] - 8 == starts[i])
                hi = (
                    next(k for k, f in enumerate(frags) if f[0] - 8 == starts[i + 1])
                    if i + 1 < self.n_frames
                    else len(frags)
                )
            except StopIteration:
                raise _DicomError("basic offset table does not match fragments") from None
            span = frags[lo:hi]
            if len(span) == 1:
                return span[0]
            # Multi-fragment frame: concatenate (rare; handled by caller)
            raise _DicomError("multi-fragment DICOM frames are not supported")
        raise _DicomError("cannot map DICOM fragments to frames (no usable BOT)")

    def decode_frame(self, i: int) -> np.ndarray:
        off, length = self.frame_span(i)
        data = self.buf[off : off + length]
        if not self.pixel["encapsulated"]:  # type: ignore[index]
            arr = np.frombuffer(data, dtype=np.uint8)
            if self.spp == 1:
                arr = arr.reshape(self.rows, self.cols)
                if self.photometric == "MONOCHROME1":
                    arr = 255 - arr
                return np.repeat(arr[:, :, None], 3, axis=2)
            return arr.reshape(self.rows, self.cols, self.spp)[:, :, :3]
        if self.ts == TS_JPEG_BASELINE:
            from atlaspatch_tpu_torch.io.native import jpeg_decode

            return jpeg_decode(bytes(data))
        # JPEG2000
        from atlaspatch_tpu_torch.io.native import j2k_decode_rgb

        force_ycbcr = self.photometric.startswith("YBR") and self.ts == TS_J2K
        arr = j2k_decode_rgb(bytes(data), self.cols, self.rows, max(self.spp, 1), force_ycbcr)
        if self.spp == 1:
            return np.repeat(arr[:, :, :1], 3, axis=2)
        return arr[:, :, :3]

    @property
    def mpp_x(self) -> Optional[float]:
        """PixelSpacing (mm) → µm/px; shared functional groups first."""
        spacing = None
        shared = self.ds.get(TAG_SHARED_FG_SQ)
        if shared:
            measures = shared[0].get(TAG_PIXEL_MEASURES_SQ)
            if measures:
                spacing = measures[0].str_val(TAG_PIXEL_SPACING)
        if spacing is None:
            spacing = self.ds.str_val(TAG_PIXEL_SPACING)
        if not spacing:
            return None
        try:
            # DS multivalue "row\col" in mm
            parts = [float(p) for p in spacing.split("\\")]
            return parts[-1] * 1000.0
        except ValueError:
            return None

    @property
    def objective_power(self) -> Optional[float]:
        paths = self.ds.get(TAG_OPTICAL_PATH_SQ)
        if paths:
            val = paths[0].str_val(TAG_OBJECTIVE_POWER)
            if val:
                try:
                    return float(val)
                except ValueError:
                    return None
        return None

    def is_pyramid_instance(self) -> bool:
        for kind in ("LABEL", "OVERVIEW", "THUMBNAIL"):
            if kind in self.image_type:
                return False
        sop = self.ds.str_val(TAG_SOP_CLASS)
        return sop is None or sop == SOP_CLASS_WSI


class DicomWSI(IWSI):
    """Pyramidal access to a DICOM WSI series (directory of .dcm levels)."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._levels: list[TiledLevel] = []
        self._instances: list[_DicomLevel] = []

    def _setup(self) -> None:
        path = Path(self.path)
        primary = _DicomLevel(path)
        # Until self._instances owns them (cleanup()/__del__ take over from
        # there), every parsed instance must be closed on ANY exit path —
        # batch runs probe many .dcm files and fds would otherwise pile up.
        instances = [primary]
        try:
            if not primary.is_pyramid_instance():
                raise RuntimeError(
                    f"dicom: {path.name} is a {primary.image_type} instance"
                )
            for sib in sorted(path.parent.iterdir()):
                if sib == path or sib.suffix.lower() not in (".dcm", ".dicom"):
                    continue
                try:
                    inst = _DicomLevel(sib)
                except Exception:
                    continue  # non-WSI DICOM or unreadable; not part of the pyramid
                if (
                    inst.is_pyramid_instance()
                    and inst.series_uid == primary.series_uid
                    and inst.series_uid is not None
                ):
                    instances.append(inst)
                else:
                    inst.close()
            instances.sort(key=lambda m: -(m.total_cols * m.total_rows))
            # Drop duplicate level sizes (multiple focal planes / optical paths).
            seen_sizes: set[tuple[int, int]] = set()
            uniq: list[_DicomLevel] = []
            for inst in instances:
                size = (inst.total_cols, inst.total_rows)
                if size not in seen_sizes:
                    seen_sizes.add(size)
                    uniq.append(inst)
                else:
                    inst.close()  # idempotent; handler below may close again
        except BaseException:
            for inst in instances:
                inst.close()
            raise
        self._instances = uniq

        w0, h0 = uniq[0].total_cols, uniq[0].total_rows
        levels: list[TiledLevel] = []
        dims: list[tuple[int, int]] = []
        downs: list[float] = []
        for inst in uniq:
            tiles = [
                (px, py, inst.cols, inst.rows, (inst, i))
                for i, (px, py) in enumerate(inst.frame_positions())
            ]
            lw, lh = inst.total_cols, inst.total_rows
            levels.append(
                TiledLevel(lw, lh, w0 / lw, tiles, self._decode_tile, (255, 255, 255))
            )
            dims.append((lw, lh))
            downs.append(w0 / lw)

        self._levels = levels
        self.w, self.h = w0, h0
        self.nlvl = len(levels)
        self.dims = dims
        self.ds = downs
        meta: dict[str, Any] = {
            "dicom.TransferSyntaxUID": primary.ts,
            "dicom.PhotometricInterpretation": primary.photometric,
        }
        if primary.series_uid:
            meta["dicom.SeriesInstanceUID"] = primary.series_uid
        if primary.objective_power is not None:
            meta["dicom.ObjectiveLensPower"] = str(primary.objective_power)
        self.meta = meta

        base = uniq[0]
        if self._mpp_manual is not None:
            self.mpp = self.validate_mpp(self._mpp_manual, source="user-provided mpp")
        else:
            # mpp must describe the BASE level (w0/h0 come from it): opening a
            # downsampled sibling would otherwise report that level's spacing
            # and the patch grid would be computed at the wrong scale.
            mpp = base.mpp_x if base.mpp_x is not None else primary.mpp_x
            self.mpp = (
                self.validate_mpp(round(mpp, 4), source="slide metadata")
                if mpp is not None
                else None
            )
        power = (
            base.objective_power
            if base.objective_power is not None
            else primary.objective_power
        )
        if power is not None:
            self.mag = int(power)
        elif self.mpp is not None:
            try:
                self.mag = self._infer_mag(self.mpp)
            except ValueError:
                self.mag = None

    @staticmethod
    def _decode_tile(key: tuple[_DicomLevel, int]) -> Optional[np.ndarray]:
        inst, frame = key
        return inst.decode_frame(frame)

    # --- IWSI surface -------------------------------------------------------
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

    def cleanup(self) -> None:
        for level in self._levels:
            level.clear_cache()
        for inst in self._instances:
            inst.close()
        self._instances = []
        self._levels = []
        self._loaded = False

    def __del__(self) -> None:
        try:
            self.cleanup()
        except Exception:
            pass


def dicom_instance_info(path) -> tuple[Optional[str], int, bool]:
    """(series_uid, total-pixel area, is_pyramid) for cohort discovery.

    Lets slide discovery keep ONE entry per DICOM series — the base (largest
    VOLUME) instance — instead of processing every level/LABEL/OVERVIEW file
    of a multi-file pyramid as its own slide. Header-only: the pixel data is
    recorded as spans, never read."""
    inst = _DicomLevel(Path(path))
    try:
        return (
            inst.series_uid,
            int(inst.total_cols or 0) * int(inst.total_rows or 0),
            inst.is_pyramid_instance(),
        )
    finally:
        inst.close()
