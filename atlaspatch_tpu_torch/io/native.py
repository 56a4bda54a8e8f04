"""ctypes bindings for the native contour tracer and containment scan.

``csrc/atlas_contours.cc`` depends only on the C++ standard library. It is
built at first use with ``g++ -O3 -std=c++17 -shared -fPIC`` into the port's
build directory (``atlaspatch_tpu_torch/build.py``) and exposes:

  native_find_contours        — Suzuki border following with CCOMP parents,
                                cv2.findContours(RETR_CCOMP, CHAIN_APPROX_NONE)
                                output order
  native_points_polygon_test  — batched cv2.pointPolygonTest(measureDist=False)

There is no OpenCV fallback: OpenCV may be absent where the port runs, so a
failed build raises. Calls release the GIL (ctypes).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from atlaspatch_tpu_torch.build import CSRC, build_shared_library

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


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
