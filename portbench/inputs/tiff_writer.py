"""A JPEG-tiled pyramidal TIFF writer (the Aperio SVS layout).

A trimmed copy of ``tests/tiff_builder.py::TiffWriter`` and ``write_pyramid``:
classic little-endian TIFF, one IFD per level, 2x downsampled levels, tiles
encoded as standalone JFIF by Pillow (compression 7), an ImageDescription on
level 0. Kept here so the benchmark's inputs do not move with the repo's test
helpers.
"""

from __future__ import annotations

import io
import struct

import numpy as np

TYPE_ASCII = 2
TYPE_SHORT = 3
TYPE_LONG = 4


class TiffWriter:
    def __init__(self) -> None:
        self.buf = bytearray(b"II*\x00\x00\x00\x00\x00")
        self.ifd_offsets: list[int] = []

    def _align(self) -> None:
        while len(self.buf) % 2:
            self.buf.append(0)

    def _write_blob(self, data: bytes) -> int:
        self._align()
        off = len(self.buf)
        self.buf.extend(data)
        return off

    def add_jpeg_level(self, image: np.ndarray, *, tile: int, quality: int = 90,
                       description: str | None = None) -> None:
        from PIL import Image

        h, w = image.shape[:2]
        offsets, counts = [], []
        for ys in range(0, h, tile):
            for xs in range(0, w, tile):
                block = np.zeros((tile, tile, 3), dtype=np.uint8)
                part = image[ys : ys + tile, xs : xs + tile]
                block[: part.shape[0], : part.shape[1]] = part
                out = io.BytesIO()
                Image.fromarray(block).save(out, "JPEG", quality=quality)
                data = out.getvalue()
                offsets.append(self._write_blob(data))
                counts.append(len(data))

        entries: list[tuple[int, int, int, bytes]] = []

        def tag(tag_id: int, type_: int, values) -> None:
            if isinstance(values, int):
                values = [values]
            if type_ == TYPE_SHORT:
                data = struct.pack(f"<{len(values)}H", *values)
            elif type_ == TYPE_LONG:
                data = struct.pack(f"<{len(values)}I", *values)
            else:  # ASCII
                data = values[0].encode() + b"\x00"
                values = [None] * len(data)
            entries.append((tag_id, type_, len(values), data))

        tag(256, TYPE_LONG, w)
        tag(257, TYPE_LONG, h)
        tag(258, TYPE_SHORT, [8, 8, 8])
        tag(259, TYPE_SHORT, 7)
        tag(262, TYPE_SHORT, 2)
        if description:
            tag(270, TYPE_ASCII, [description])
        tag(277, TYPE_SHORT, 3)
        tag(322, TYPE_LONG, tile)
        tag(323, TYPE_LONG, tile)
        tag(324, TYPE_LONG, offsets)
        tag(325, TYPE_LONG, counts)
        tag(284, TYPE_SHORT, 1)
        entries.sort(key=lambda e: e[0])
        finalized = []
        for tag_id, type_, count, data in entries:
            if len(data) <= 4:
                finalized.append((tag_id, type_, count, data + b"\x00" * (4 - len(data))))
            else:
                finalized.append((tag_id, type_, count, struct.pack("<I", self._write_blob(data))))
        self._align()
        ifd_off = len(self.buf)
        self.buf.extend(struct.pack("<H", len(finalized)))
        for tag_id, type_, count, value4 in finalized:
            self.buf.extend(struct.pack("<HHI", tag_id, type_, count) + value4)
        self.buf.extend(b"\x00\x00\x00\x00")
        self.ifd_offsets.append(ifd_off)

    def save(self, path) -> None:
        buf = self.buf
        struct.pack_into("<I", buf, 4, self.ifd_offsets[0])
        for i in range(len(self.ifd_offsets) - 1):
            ifd_off = self.ifd_offsets[i]
            n = struct.unpack_from("<H", buf, ifd_off)[0]
            struct.pack_into("<I", buf, ifd_off + 2 + n * 12, self.ifd_offsets[i + 1])
        with open(path, "wb") as f:
            f.write(buf)


def write_pyramid(path, level0: np.ndarray, *, levels: int, tile: int, description: str) -> None:
    """Levels by 2x subsampling, as ``tests/tiff_builder.py::write_pyramid``."""
    writer = TiffWriter()
    arr = level0
    for i in range(levels):
        if i:
            arr = arr[::2, ::2].copy()
        writer.add_jpeg_level(arr, tile=tile, description=description if i == 0 else None)
    writer.save(path)
