"""Decode the chunks of a tiled TIFF pyramid with Pillow, independently of the
port's native decoder (csrc/atlas_tiff.cc), to hold that decoder's output
against another implementation on the same bytes.

The TIFF container is walked here (classic little-endian TIFF, the layout
``tests/tiff_builder.py`` writes), and each JPEG tile is decoded by Pillow
(its own libjpeg-turbo build), optionally in its scaled draft mode, which is
libjpeg's IDCT scaling as the native scaled read uses it. Where the native
decoder links that same bundled libjpeg, the JPEG decode itself is shared
and only the container walk, tile assembly and colour maths are checked. A JPEG2000 tile of
Aperio compression 33003 is decoded by Pillow's openjpeg and its YCbCr
components turned into RGB with the fixed-point transform libjpeg uses
(the oracle of tests/test_native_tiff.py).

    from atlaspatch_tpu_torch.tools.pillow_check import tiled_region, j2k_ycbcr_tile
    want = tiled_region(path, ifd=0, x=512, y=512, w=1024, h=1024, scale=1)

Used by ``chip_smoke.py``'s tiff phase on the card's host and by
``tests/test_torch_native_tiff.py`` on the CPU.
"""

from __future__ import annotations

import io
import struct
from pathlib import Path

import numpy as np


def tiff_ifds(path) -> list[dict[int, list[int]]]:
    """Every IFD of a classic little-endian TIFF as {tag: integer values}
    (SHORT and LONG tags only; others are skipped)."""
    data = Path(path).read_bytes()
    if data[:4] != b"II*\x00":
        raise ValueError("not a classic little-endian TIFF")
    ifds, off = [], struct.unpack_from("<I", data, 4)[0]
    while off:
        n = struct.unpack_from("<H", data, off)[0]
        tags = {}
        for i in range(n):
            tag, typ, count, value = struct.unpack_from("<HHII", data, off + 2 + 12 * i)
            if typ not in (3, 4):
                continue
            size = 2 if typ == 3 else 4
            at = off + 10 + 12 * i if count * size <= 4 else value
            tags[tag] = list(struct.unpack_from(f"<{count}{'H' if typ == 3 else 'I'}", data, at))
        ifds.append(tags)
        off = struct.unpack_from("<I", data, off + 2 + 12 * n)[0]
    return ifds


def _tiles(path, ifd: int):
    tags = tiff_ifds(path)[ifd]
    data = Path(path).read_bytes()
    w, h, tw, th = tags[256][0], tags[257][0], tags[322][0], tags[323][0]
    chunks = [data[o : o + c] for o, c in zip(tags[324], tags[325])]
    return w, h, tw, th, chunks


def tiled_region(path, ifd: int, x: int, y: int, w: int, h: int, scale: int = 1) -> np.ndarray:
    """The (x, y, w, h) region of a JPEG-tiled level, in level pixels, decoded
    tile by tile by Pillow at 1/``scale``: ceil(h / scale) x ceil(w / scale).
    x and y lie on the tile grid; the region ends on it or at the level's edge."""
    from PIL import Image

    lw, lh, tw, th, chunks = _tiles(path, ifd)
    across = -(-lw // tw)
    ends_ok = ((x + w) % tw == 0 or x + w == lw) and ((y + h) % th == 0 or y + h == lh)
    if x % tw or y % th or not ends_ok or tw % scale or th % scale:
        raise ValueError("the region must lie on the tile grid")
    out = np.zeros((-(-h // scale), -(-w // scale), 3), np.uint8)
    for ty in range(y // th, -(-(y + h) // th)):
        for tx in range(x // tw, -(-(x + w) // tw)):
            img = Image.open(io.BytesIO(chunks[ty * across + tx]))
            if scale > 1:
                img.draft("RGB", (tw // scale, th // scale))
            tile = np.asarray(img.convert("RGB"))
            if tile.shape[:2] != (th // scale, tw // scale):
                raise ValueError(f"Pillow decoded a tile to {tile.shape[:2]}")
            oy, ox = (ty * th - y) // scale, (tx * tw - x) // scale
            clip = tile[: out.shape[0] - oy, : out.shape[1] - ox]
            out[oy : oy + clip.shape[0], ox : ox + clip.shape[1]] = clip
    return out


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """Full-range YCbCr to RGB in libjpeg's 16-bit fixed point."""
    y = ycc[..., 0].astype(np.int64)
    cb = ycc[..., 1].astype(np.int64) - 128
    cr = ycc[..., 2].astype(np.int64) - 128
    rgb = np.stack(
        [
            y + ((91881 * cr + 32768) >> 16),
            y - ((22554 * cb + 46802 * cr + 32768) >> 16),
            y + ((116130 * cb + 32768) >> 16),
        ],
        axis=-1,
    )
    return np.clip(rgb, 0, 255).astype(np.uint8)


def j2k_ycbcr_tile(path, ifd: int, index: int) -> np.ndarray:
    """Tile ``index`` of an Aperio 33003 level: Pillow's openjpeg decode of the
    raw codestream (YCbCr components, no in-stream transform), then RGB."""
    from PIL import Image

    *_, chunks = _tiles(path, ifd)
    return ycbcr_to_rgb(np.asarray(Image.open(io.BytesIO(chunks[index]))))
