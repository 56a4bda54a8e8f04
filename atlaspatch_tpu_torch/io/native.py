"""ctypes bindings for the port's host libraries: geometry and slide decode.

``csrc/atlas_contours.cc`` (library ``atlas_contours``) depends only on the
C++ standard library and exposes:

  native_find_contours        — Suzuki border following with CCOMP parents,
                                cv2.findContours(RETR_CCOMP, CHAIN_APPROX_NONE)
                                output order
  native_points_polygon_test  — batched cv2.pointPolygonTest(measureDist=False)

``csrc/atlas_tiff.cc`` + ``csrc/atlas_j2k.cc`` (library ``atlas_tiff``) are
the TIFF / SVS / NDPI / SCN / BIF pyramid decoder and the standalone JPEG and
JPEG2000 decoders of the MIRAX, Hamamatsu and DICOM readers:

  AtlasTiffFile                          — pyramid levels, properties,
                                           region reads, IDCT-scaled reads
  jpeg_image_info / jpeg_decode          — standalone JPEG streams
  jpeg_decode_window                     — crop-and-skip window decode
  j2k_decode_rgb                         — JPEG2000 codestreams

Both are built at first use with ``g++ -O3 -std=c++17 -shared -fPIC`` into
the port's build directory (``atlaspatch_tpu_torch/build.py``). The decoder
links libjpeg and zlib. It always compiles against the libjpeg-turbo 2.1.5
headers in ``csrc/vendor/libjpeg`` (ABI 62) and links, by absolute path with
an rpath, the system's ``libjpeg.so.62`` or else the libjpeg-turbo that
Pillow's wheel bundles, so every host builds it the same way.
``jpeg_CreateDecompress`` checks the struct size, so an ABI mismatch fails
loudly. libopenjp2 is opened at the first JPEG2000 decode: the
system's ``libopenjp2.so.7`` first, else Pillow's bundled copy; without
either, J2K decode raises and every other codec works.

There is no OpenCV or Pillow fallback for any of these: a failed build
raises with the compiler's log. Calls release the GIL (ctypes), so thread
pools decode in parallel.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from atlaspatch_tpu_torch.build import CSRC, build_shared_library

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TIFF_LOCK = threading.Lock()
_TIFF_LIB: ctypes.CDLL | None = None
_TIFF_BUILD: dict[str, str] = {}
VENDORED_LIBJPEG = CSRC / "vendor" / "libjpeg"


def load_contours_library() -> ctypes.CDLL:
    """Build (once) and load the contour library; raises if the build fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = build_shared_library(
            "atlas_contours",
            [CSRC / "atlas_contours.cc"],
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"],
        )
        lib = ctypes.CDLL(str(path))
        lib.atlas_find_contours.restype = ctypes.c_int
        lib.atlas_find_contours.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.atlas_points_polygon_test.restype = ctypes.c_int
        lib.atlas_points_polygon_test.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int8),
        ]
        _LIB = lib
        return lib


def native_points_polygon_test(polygon: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Batched pointPolygonTest(measureDist=False): (M,) int8 of +1/0/-1.

    The polygon must be non-empty (ops/polygon.py handles the empty case)."""
    lib = load_contours_library()
    poly = np.ascontiguousarray(np.asarray(polygon, dtype=np.int64).reshape(-1, 2))
    pts = np.ascontiguousarray(np.asarray(points, dtype=np.int64).reshape(-1, 2))
    out = np.empty(pts.shape[0], dtype=np.int8)
    rc = lib.atlas_points_polygon_test(
        poly.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        poly.shape[0],
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        pts.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
    )
    if rc != 0:
        raise RuntimeError(f"atlas_points_polygon_test failed ({rc})")
    return out


def native_find_contours(mask_u8: np.ndarray) -> tuple[list[np.ndarray], np.ndarray]:
    """Binary mask {0,255} → (contours as (N,1,2) int32 list, parents int64).

    Matches cv2.findContours(RETR_CCOMP, CHAIN_APPROX_NONE) output."""
    lib = load_contours_library()
    mask = np.ascontiguousarray(mask_u8, dtype=np.uint8)
    h, w = mask.shape[:2]
    mask_ptr = mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    # First pass: count
    n = lib.atlas_find_contours(mask_ptr, h, w, 1 << 22, None, None, None, None, 0)
    if n < 0:
        raise RuntimeError(f"atlas_find_contours failed ({n})")
    if n == 0:
        return [], np.empty((0,), dtype=np.int64)

    n_points = np.zeros(n, dtype=np.int64)
    parents = np.zeros(n, dtype=np.int64)
    is_hole = np.zeros(n, dtype=np.uint8)
    # Upper bound on total boundary length: all pixels
    capacity = int(mask.size) * 4 + 8 * n
    points = np.zeros(capacity, dtype=np.int64)
    rc = lib.atlas_find_contours(
        mask_ptr,
        h,
        w,
        n,
        n_points.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        parents.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        is_hole.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        capacity,
    )
    if rc < 0:
        raise RuntimeError(f"atlas_find_contours failed ({rc})")

    contours: list[np.ndarray] = []
    off = 0
    for i in range(n):
        cnt = points[off : off + 2 * n_points[i]].reshape(-1, 2).astype(np.int32)
        contours.append(cnt.reshape(-1, 1, 2))
        off += 2 * int(n_points[i])

    # Reorder to cv2's output sequence: top-level contours in reverse discovery
    # order, each immediately followed by its holes (also reverse discovery).
    children: dict[int, list[int]] = {}
    top: list[int] = []
    for i in range(n):
        if parents[i] == -1:
            top.append(i)
        else:
            children.setdefault(int(parents[i]), []).append(i)
    order: list[int] = []
    for t in reversed(top):
        order.append(t)
        order.extend(reversed(children.get(t, [])))
    new_index = {old: new for new, old in enumerate(order)}
    out_contours = [contours[old] for old in order]
    out_parents = np.array(
        [-1 if parents[old] == -1 else new_index[int(parents[old])] for old in order],
        dtype=np.int64,
    )
    return out_contours, out_parents


# ------------------------------------------------------------ slide decoder
def _system_library(soname: str) -> str | None:
    """Absolute path of ``soname`` in the dynamic linker's cache, if listed."""
    ldconfig = shutil.which("ldconfig") or "/sbin/ldconfig"
    try:
        listing = subprocess.run([ldconfig, "-p"], capture_output=True, text=True).stdout
    except OSError:
        return None
    for line in listing.splitlines():
        name, _, path = line.strip().partition(" => ")
        if name.split(" ")[0] == soname and Path(path).exists():
            return path
    return None


def _pillow_bundled(pattern: str) -> str | None:
    """A shared object that Pillow's wheel bundles (``pillow.libs/<pattern>``)."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.submodule_search_locations:
        return None
    found = sorted((Path(spec.submodule_search_locations[0]).parent / "pillow.libs").glob(pattern))
    return str(found[0]) if found else None


def _libjpeg_flags() -> tuple[list[str], list[str], dict[str, str]]:
    """(compile flags, link arguments, description) for libjpeg: the vendored
    headers, and the system's ``libjpeg.so.62`` or else Pillow's by path."""
    lib = _system_library("libjpeg.so.62") or _pillow_bundled("libjpeg-*.so.62*")
    if lib is None:
        raise RuntimeError(
            "building atlas_tiff: no libjpeg with ABI 62 (system libjpeg.so.62 or "
            "Pillow's bundled libjpeg) to link"
        )
    flags = ["-I", str(VENDORED_LIBJPEG)]
    link = [lib, f"-Wl,-rpath,{Path(lib).parent}"]
    return flags, link, {"jpeg_headers": str(VENDORED_LIBJPEG), "libjpeg": lib}


def load_tiff_library() -> ctypes.CDLL:
    """Build (once) and load the slide decoder; raises if the build fails."""
    global _TIFF_LIB
    with _TIFF_LOCK:
        if _TIFF_LIB is not None:
            return _TIFF_LIB
        flags, link, info = _libjpeg_flags()
        path = build_shared_library(
            "atlas_tiff",
            [CSRC / "atlas_tiff.cc", CSRC / "atlas_j2k.cc"],
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *flags],
            [*link, "-lz", "-ldl"],
            headers=sorted(VENDORED_LIBJPEG.glob("*.h")),
        )
        lib = ctypes.CDLL(str(path))
        _declare_tiff_api(lib)
        openjp2 = _pillow_bundled("libopenjp2-*.so*")
        if openjp2 is not None:
            lib.atlas_j2k_set_library(openjp2.encode())
        _TIFF_BUILD.update(info, library=str(path), openjp2_fallback=openjp2 or "")
        _TIFF_LIB = lib
        return lib


def tiff_library_info() -> dict[str, str]:
    """How the loaded decoder was built: the libjpeg headers used, the libjpeg
    linked, the .so, and the libopenjp2 tried after the system sonames."""
    load_tiff_library()
    return dict(_TIFF_BUILD)


def _declare_tiff_api(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    lib.atlas_open.restype = ctypes.c_void_p
    lib.atlas_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.atlas_close.restype = None
    lib.atlas_close.argtypes = [ctypes.c_void_p]
    lib.atlas_num_levels.restype = ctypes.c_int
    lib.atlas_num_levels.argtypes = [ctypes.c_void_p]
    lib.atlas_level_info.restype = None
    lib.atlas_level_info.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(i64),
        ctypes.POINTER(i64),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.atlas_properties_json.restype = ctypes.c_char_p
    lib.atlas_properties_json.argtypes = [ctypes.c_void_p]
    lib.atlas_read_region.restype = ctypes.c_int
    lib.atlas_read_region.argtypes = [
        ctypes.c_void_p, ctypes.c_int, i64, i64, i64, i64, u8p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.atlas_read_region_scaled.restype = ctypes.c_int
    lib.atlas_read_region_scaled.argtypes = [
        ctypes.c_void_p, ctypes.c_int, i64, i64, i64, i64, ctypes.c_int, u8p,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.atlas_j2k_decode.restype = ctypes.c_int
    lib.atlas_j2k_decode.argtypes = [
        u8p, i64, u8p, i64, i64, ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.atlas_j2k_set_library.restype = None
    lib.atlas_j2k_set_library.argtypes = [ctypes.c_char_p]
    lib.atlas_jpeg_info.restype = ctypes.c_int
    lib.atlas_jpeg_info.argtypes = [u8p, i64, ctypes.c_int, ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.atlas_jpeg_decode.restype = ctypes.c_int
    lib.atlas_jpeg_decode.argtypes = [u8p, i64, ctypes.c_int, u8p, i64, i64]
    lib.atlas_jpeg_decode_window.restype = ctypes.c_int
    lib.atlas_jpeg_decode_window.argtypes = [u8p, i64, ctypes.c_int, i64, i64, i64, i64, u8p]


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class AtlasTiffFile:
    """Thin RAII wrapper over the native pyramid decoder."""

    def __init__(self, path: str) -> None:
        lib = load_tiff_library()
        err = ctypes.create_string_buffer(512)
        handle = lib.atlas_open(str(path).encode(), err, len(err))
        if not handle:
            raise RuntimeError(
                f"atlas_tiff: cannot open {path}: {err.value.decode(errors='replace')}"
            )
        self._lib = lib
        self._handle = ctypes.c_void_p(handle)
        self.path = str(path)
        self.level_count = lib.atlas_num_levels(self._handle)
        self.level_dimensions: list[tuple[int, int]] = []
        self.level_downsamples: list[float] = []
        for lv in range(self.level_count):
            w = ctypes.c_int64()
            h = ctypes.c_int64()
            ds = ctypes.c_double()
            lib.atlas_level_info(self._handle, lv, ctypes.byref(w), ctypes.byref(h), ctypes.byref(ds))
            self.level_dimensions.append((int(w.value), int(h.value)))
            self.level_downsamples.append(float(ds.value))
        self.properties: dict[str, str] = json.loads(
            lib.atlas_properties_json(self._handle).decode(errors="replace")
        )

    @property
    def dimensions(self) -> tuple[int, int]:
        return self.level_dimensions[0]

    def read_region_level(self, level: int, x: int, y: int, w: int, h: int) -> np.ndarray:
        """Read an RGB region; x/y in LEVEL coordinates. Out-of-bounds pads
        black (OpenSlide read_region parity)."""
        out = np.empty((h, w, 3), dtype=np.uint8)
        err = ctypes.create_string_buffer(512)
        rc = self._lib.atlas_read_region(
            self._handle, int(level), int(x), int(y), int(w), int(h), _u8(out), err, len(err)
        )
        if rc != 0:
            raise RuntimeError(
                f"atlas_tiff: read_region failed: {err.value.decode(errors='replace')}"
            )
        return out

    def read_region_level_scaled(
        self, level: int, x: int, y: int, w: int, h: int, scale_denom: int
    ) -> "np.ndarray | None":
        """Read an RGB region decoded at 1/scale_denom (libjpeg IDCT scaling).

        x/y/w/h in LEVEL coordinates; output is ceil(w/s) x ceil(h/s) x 3.
        Returns None when the level cannot be decoded scaled (non-JPEG
        compression, off-grid geometry) — callers fall back to
        read_region_level + host resize. Backs the thumbnail fast path.
        """
        s = int(scale_denom)
        out = np.empty(((h + s - 1) // s, (w + s - 1) // s, 3), dtype=np.uint8)
        err = ctypes.create_string_buffer(512)
        rc = self._lib.atlas_read_region_scaled(
            self._handle, int(level), int(x), int(y), int(w), int(h), s, _u8(out), err, len(err)
        )
        if rc == -2:
            return None
        if rc != 0:
            raise RuntimeError(
                f"atlas_tiff: scaled read failed: {err.value.decode(errors='replace')}"
            )
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.atlas_close(self._handle)
            self._handle = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


def jpeg_image_info(buf: bytes, scale_denom: int = 1) -> tuple[int, int]:
    """(width, height) of a standalone JPEG stream at 1/scale_denom."""
    lib = load_tiff_library()
    data = np.frombuffer(buf, dtype=np.uint8)
    w = ctypes.c_int64()
    h = ctypes.c_int64()
    rc = lib.atlas_jpeg_info(_u8(data), data.size, int(scale_denom), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise RuntimeError("atlas_jpeg_info: not a decodable JPEG stream")
    return int(w.value), int(h.value)


def jpeg_decode(buf: bytes, scale_denom: int = 1) -> np.ndarray:
    """Decode a standalone JPEG stream to an RGB uint8 array at 1/scale_denom
    (the tiles of the MIRAX, Hamamatsu and DICOM readers)."""
    w, h = jpeg_image_info(buf, scale_denom)
    lib = load_tiff_library()
    data = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty((h, w, 3), dtype=np.uint8)
    rc = lib.atlas_jpeg_decode(_u8(data), data.size, int(scale_denom), _u8(out), w, h)
    if rc != 0:
        raise RuntimeError(f"atlas_jpeg_decode failed ({rc})")
    return out


def jpeg_decode_window(
    buf: bytes, scale_denom: int, x: int, y: int, w: int, h: int
) -> np.ndarray:
    """Decode only an (x, y, w, h) window of a JPEG stream, in coordinates of
    the 1/scale_denom output space (libjpeg-turbo crop + skip-scanlines).

    Cost scales with the window's MCU rows, not the whole image, so the
    Hamamatsu VMS reader never decodes a multi-gigapixel source JPEG whole
    per region read."""
    lib = load_tiff_library()
    data = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty((h, w, 3), dtype=np.uint8)
    rc = lib.atlas_jpeg_decode_window(
        _u8(data), data.size, int(scale_denom), int(x), int(y), int(w), int(h), _u8(out)
    )
    if rc != 0:
        raise RuntimeError(f"atlas_jpeg_decode_window failed ({rc})")
    return out


def j2k_decode_rgb(buf: bytes, w: int, h: int, spp: int = 3, force_ycbcr: bool = False) -> np.ndarray:
    """Decode a JPEG2000 codestream of known dimensions to an (h, w, spp) array
    (the DICOM reader's .4.90/.4.91 frames; dims come from the dataset)."""
    lib = load_tiff_library()
    data = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty((h, w, spp), dtype=np.uint8)
    err = ctypes.create_string_buffer(256)
    rc = lib.atlas_j2k_decode(
        _u8(data), data.size, _u8(out), w, h, int(spp), 1 if force_ycbcr else 0, err, len(err)
    )
    if rc != 0:
        raise RuntimeError(f"atlas_j2k_decode failed: {err.value.decode(errors='replace')}")
    return out
