"""Shared tile-composite plumbing for non-TIFF slide containers.

MIRAX, Hamamatsu VMS and DICOM WSI all present a pyramid level as a set of
positioned RGB tiles (JPEG or raw). This module provides the common piece:
given tile boxes + a decode callback, composite an arbitrary region request
into an RGB buffer over a fill color — the same job OpenSlide's tile cache +
paste loop does for these formats in the reference's stack
(reference: atlas_patch/core/wsi/openslide_wsi.py:198 read_region).

Tiles are bucketed on a coarse grid so region reads touch O(tiles in view),
not O(all tiles); decoded tiles go through a small per-level LRU so adjacent
patch reads don't re-decode their shared tile.
"""

from __future__ import annotations

from collections import OrderedDict
from threading import Lock
from typing import Callable, Iterable, Optional, Tuple

import numpy as np

Tile = Tuple[int, int, int, int, object]  # px, py, tw, th, key


class TiledLevel:
    """One pyramid level composed of positioned tiles.

    decode(key) must return an RGB uint8 array (any size — pasted clipped to
    the declared tile box) or None for a missing tile (left as fill).
    """

    def __init__(
        self,
        width: int,
        height: int,
        downsample: float,
        tiles: Iterable[Tuple[int, int, int, int, object]],
        decode: Callable[[object], Optional[np.ndarray]],
        fill_rgb: Tuple[int, int, int] = (255, 255, 255),
        cache_tiles: int = 16,
        decode_window: Optional[Callable[[object, int, int, int, int], Optional[np.ndarray]]] = None,
        window_threshold_bytes: int = 64 << 20,
    ) -> None:
        self.width = int(width)
        self.height = int(height)
        self.downsample = float(downsample)
        self._decode = decode
        # Optional partial decode: decode_window(key, x, y, w, h) with x/y in
        # TILE-LOCAL pixels. Used (and never cached) for tiles whose full
        # decoded size exceeds window_threshold_bytes — a multi-gigapixel VMS
        # source JPEG must not decode (or allocate) whole per patch read.
        self._decode_window = decode_window
        self._window_threshold = int(window_threshold_bytes)
        self.fill_rgb = tuple(int(c) for c in fill_rgb)
        self._tiles: list[Tile] = [tuple(t) for t in tiles]  # type: ignore[misc]
        # Bucket tiles on a grid of the max tile size so lookup is local.
        self._bw = max((t[2] for t in self._tiles), default=1)
        self._bh = max((t[3] for t in self._tiles), default=1)
        self._buckets: dict[tuple[int, int], list[Tile]] = {}
        for t in self._tiles:
            for bx in range(t[0] // self._bw, (t[0] + t[2] - 1) // self._bw + 1):
                for by in range(t[1] // self._bh, (t[1] + t[3] - 1) // self._bh + 1):
                    self._buckets.setdefault((bx, by), []).append(t)
        self._cache: OrderedDict[object, Optional[np.ndarray]] = OrderedDict()
        self._cache_cap = int(cache_tiles)
        self._lock = Lock()
        # per-key in-flight latch: concurrent misses on one tile decode ONCE
        # (adjacent patch reads share tiles; on a small host N redundant
        # full-tile decodes would serialize on the CPU)
        self._inflight: dict[object, object] = {}

    # --- decode cache ---------------------------------------------------
    def _tile_array(self, key: object) -> Optional[np.ndarray]:
        from threading import Event

        while True:
            with self._lock:
                if key in self._cache:
                    self._cache.move_to_end(key)
                    return self._cache[key]
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = Event()
                    break
            ev.wait()  # another thread is decoding this tile; re-check cache

        try:
            arr = self._decode(key)
        except BaseException:
            with self._lock:
                self._inflight.pop(key).set()  # wake waiters; they will retry
            raise
        with self._lock:
            self._cache[key] = arr
            if len(self._cache) > self._cache_cap:
                self._cache.popitem(last=False)
            self._inflight.pop(key).set()
        return arr

    def clear_cache(self) -> None:
        with self._lock:
            self._cache.clear()

    # --- region composite -------------------------------------------------
    def read_region(self, x: int, y: int, w: int, h: int) -> np.ndarray:
        """Composite the (x, y, w, h) region in LEVEL pixels. Out-of-bounds
        and missing-tile areas take the fill color."""
        out = np.empty((h, w, 3), dtype=np.uint8)
        out[:] = np.asarray(self.fill_rgb, dtype=np.uint8)
        if w <= 0 or h <= 0:
            return out
        x1, y1 = x + w, y + h
        seen: set[int] = set()
        for bx in range((x - self._bw) // self._bw, x1 // self._bw + 1):
            for by in range((y - self._bh) // self._bh, y1 // self._bh + 1):
                for t in self._buckets.get((bx, by), ()):
                    if id(t) in seen:
                        continue
                    seen.add(id(t))
                    px, py, tw, th, key = t
                    ix0, iy0 = max(x, px), max(y, py)
                    ix1, iy1 = min(x1, px + tw), min(y1, py + th)
                    if ix0 >= ix1 or iy0 >= iy1:
                        continue
                    big = 3 * tw * th > self._window_threshold
                    cached = False
                    with self._lock:
                        cached = key in self._cache
                    if self._decode_window is not None and big and not cached:
                        win = self._decode_window(
                            key, ix0 - px, iy0 - py, ix1 - ix0, iy1 - iy0
                        )
                        if win is not None:
                            # Clip to the decoded window's real size (a
                            # fallback decode may come up short near edges).
                            wh_ = min(iy1 - iy0, win.shape[0])
                            ww_ = min(ix1 - ix0, win.shape[1])
                            out[iy0 - y : iy0 - y + wh_, ix0 - x : ix0 - x + ww_] = (
                                win[:wh_, :ww_, :3]
                            )
                            continue
                        # None: fall through to the full-tile decode below.
                    arr = self._tile_array(key)
                    if arr is None:
                        continue
                    # Clip the intersection to the decoded array's real size
                    # (defensive: container metadata may over-declare).
                    ix1 = min(ix1, px + arr.shape[1])
                    iy1 = min(iy1, py + arr.shape[0])
                    if ix0 >= ix1 or iy0 >= iy1:
                        continue
                    out[iy0 - y : iy1 - y, ix0 - x : ix1 - x] = arr[
                        iy0 - py : iy1 - py, ix0 - px : ix1 - px, :3
                    ]
        return out


# Hostile container metadata can declare absurd level dimensions (e.g. a
# corrupt MIRAX camera-position buffer placing a tile at x = 2^31); a
# whole-level thumbnail read would then try to allocate terabytes and hang
# the process inside the fill. Refusing loudly is the hardening contract
# (clean exception, never a hang) — real slides' thumbnail source levels are
# orders of magnitude below this cap (100 MPix = 300 MB RGB).
THUMB_SOURCE_PIXEL_CAP = 100_000_000


def thumb_from_level(level: TiledLevel, max_hw: Tuple[int, int]):
    """Read a whole TiledLevel and fit it into max_hw as a PIL thumbnail,
    refusing level dimensions beyond THUMB_SOURCE_PIXEL_CAP."""
    from PIL import Image

    lw, lh = level.width, level.height
    if lw <= 0 or lh <= 0 or lw * lh > THUMB_SOURCE_PIXEL_CAP:
        raise RuntimeError(
            f"thumbnail source level {lw}x{lh} exceeds the "
            f"{THUMB_SOURCE_PIXEL_CAP}-pixel safety cap (corrupt metadata?)"
        )
    arr = level.read_region(0, 0, lw, lh)
    img = Image.fromarray(arr)
    img.thumbnail(max_hw, Image.Resampling.LANCZOS)
    return img.convert("RGB")
