"""Plain reads of the cohort's slides: a classic-TIFF IFD walk and Pillow's
JPEG decoder, tile by tile.

Levels are the file's IFDs in order; a region in level coordinates that runs
past the level's edge reads black there (OpenSlide's convention). The
thumbnail at an objective power is the level whose downsample equals
base magnification / power, read whole, as the cohort is written with such a
level.
"""

from __future__ import annotations

import io
import re
import struct
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

_TYPES = {3: ("H", 2), 4: ("I", 4), 2: ("s", 1)}


@dataclass(frozen=True)
class Level:
    width: int
    height: int
    tile: int
    offsets: tuple[int, ...]
    counts: tuple[int, ...]


@dataclass(frozen=True)
class SlideFile:
    path: str
    levels: tuple[Level, ...]
    description: str

    @property
    def magnification(self) -> float:
        return float(re.search(r"AppMag = ([0-9.]+)", self.description).group(1))


@lru_cache(maxsize=64)
def open_slide(path: str) -> SlideFile:
    data = Path(path).read_bytes()
    if data[:4] != b"II*\x00":
        raise ValueError(f"{path}: not a little-endian classic TIFF")
    levels, description = [], ""
    off = struct.unpack_from("<I", data, 4)[0]
    while off:
        n = struct.unpack_from("<H", data, off)[0]
        tags = {}
        for i in range(n):
            tag, typ, count, value = struct.unpack_from("<HHI4s", data, off + 2 + 12 * i)
            fmt, size = _TYPES[typ]
            raw = value if count * size <= 4 else data[struct.unpack("<I", value)[0]:][: count * size]
            tags[tag] = raw[:count] if typ == 2 else struct.unpack(f"<{count}{fmt}", raw[: count * size])
        if 270 in tags:
            description = tags[270].rstrip(b"\x00").decode()
        levels.append(Level(tags[256][0], tags[257][0], tags[322][0], tags[324], tags[325]))
        off = struct.unpack_from("<I", data, off + 2 + 12 * n)[0]
    return SlideFile(path, tuple(levels), description)


def _tile(path: str, level: Level, index: int) -> np.ndarray:
    from PIL import Image

    with open(path, "rb") as f:
        f.seek(level.offsets[index])
        payload = f.read(level.counts[index])
    return np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))


def read_region(slide: SlideFile, level: int, x: int, y: int, w: int, h: int) -> np.ndarray:
    """(h, w, 3) uint8 of ``level`` at level coordinates (x, y); black outside."""
    lv = slide.levels[level]
    out = np.zeros((h, w, 3), dtype=np.uint8)
    x0, y0, x1, y1 = max(x, 0), max(y, 0), min(x + w, lv.width), min(y + h, lv.height)
    if x0 >= x1 or y0 >= y1:
        return out
    across = -(-lv.width // lv.tile)
    t = lv.tile
    for ty in range(y0 // t, (y1 - 1) // t + 1):
        for tx in range(x0 // t, (x1 - 1) // t + 1):
            tile = _tile(slide.path, lv, ty * across + tx)
            sx0, sy0 = max(x0, tx * t), max(y0, ty * t)
            sx1, sy1 = min(x1, (tx + 1) * t), min(y1, (ty + 1) * t)
            out[sy0 - y : sy1 - y, sx0 - x : sx1 - x] = tile[sy0 - ty * t : sy1 - ty * t, sx0 - tx * t : sx1 - tx * t]
    return out


def thumbnail(slide: SlideFile, power: float) -> np.ndarray:
    """The whole level whose downsample is magnification / power."""
    base = slide.levels[0]
    ds = slide.magnification / power
    for i, lv in enumerate(slide.levels):
        if abs(base.width / lv.width - ds) < 1e-6:
            return read_region(slide, i, 0, 0, lv.width, lv.height)
    raise ValueError(f"{slide.path}: no level at downsample {ds}")


def tissue_mask(thumb: np.ndarray, below: int) -> np.ndarray:
    """Pixels whose luma (Pillow's "L" conversion) lies under ``below``."""
    from PIL import Image

    return np.asarray(Image.fromarray(thumb).convert("L")) < below
