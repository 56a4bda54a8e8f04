"""Tissue mask → contour geometry → vectorized patch-grid containment.

Mirrors the reference geometry semantics exactly (reference:
atlas_patch/utils/contours.py:41-131, services/extraction.py:67-128) while
replacing the per-point Python loops with batched array ops:

  * mask → CCOMP contours: Suzuki border following in the native C++ tracer
    (csrc/atlas_contours.cc, bound in io/native.py). There is no OpenCV
    fallback: a failed build raises.
  * area thresholds: tissue >= tissue_area_thresh * mask_area; holes >= a_h=16,
    globally capped at max_n_holes=10 largest.
  * containment: 4 probe points at center ± int(patch//2 * center_shift); a
    candidate is tissue when ANY probe has pointPolygonTest >= 0 against its
    tissue contour AND its center is not strictly inside any of that contour's
    holes. Evaluated for the whole candidate grid at once via
    ops.polygon.point_polygon_test.
"""

from __future__ import annotations

import numpy as np

from atlaspatch_tpu_torch.ops.polygon import contour_area, point_polygon_test


def find_contours_ccomp(mask_u8: np.ndarray) -> tuple[list[np.ndarray], np.ndarray]:
    """Binary uint8 mask {0,255} → (contours, parents).

    Returns CHAIN_APPROX_NONE contours as (N,1,2) int32 arrays plus a parent
    index per contour (-1 for outer borders), matching cv2.findContours with
    RETR_CCOMP ordering, from the native C++ Suzuki tracer.
    """
    from atlaspatch_tpu_torch.io.native import native_find_contours

    return native_find_contours(mask_u8)


def mask_to_contours(
    mask: np.ndarray,
    *,
    tissue_area_thresh: float = 0.01,
    filter_params: dict[str, int] | None = None,
) -> tuple[list[np.ndarray], list[list[np.ndarray]]]:
    """Binary mask in [0,1] → (tissue contours, per-tissue hole lists)."""
    if filter_params is None:
        filter_params = {"a_h": 16, "max_n_holes": 10}

    mask_uint8 = (np.asarray(mask) > 0.5).astype(np.uint8) * 255
    contours, parents = find_contours_ccomp(mask_uint8)
    if len(contours) == 0:
        return [], []

    H, W = mask.shape[:2]
    min_area_threshold = tissue_area_thresh * float(H * W)
    hole_area_threshold = float(filter_params.get("a_h", 0))

    tissue_indices: list[int] = []
    holes_by_parent_index: dict[int, list[np.ndarray]] = {}
    for i, cont in enumerate(contours):
        area = contour_area(cont)
        parent = int(parents[i])
        if parent == -1:
            if area >= min_area_threshold:
                tissue_indices.append(i)
        else:
            if area >= hole_area_threshold:
                holes_by_parent_index.setdefault(parent, []).append(cont)

    # Global cap: keep only the max_n_holes largest holes across all parents.
    all_holes = [h for hs in holes_by_parent_index.values() for h in hs]
    max_n_holes = int(filter_params.get("max_n_holes", 0))
    if max_n_holes > 0 and len(all_holes) > max_n_holes:
        allowed = set(
            map(id, sorted(all_holes, key=contour_area, reverse=True)[:max_n_holes])
        )
        for parent, hs in list(holes_by_parent_index.items()):
            holes_by_parent_index[parent] = [h for h in hs if id(h) in allowed]

    tissue_contours = [contours[ti] for ti in tissue_indices]
    holes_per_tissue = [list(holes_by_parent_index.get(ti, [])) for ti in tissue_indices]
    return tissue_contours, holes_per_tissue


def scale_contours(contours: list[np.ndarray], sx: float, sy: float) -> list[np.ndarray]:
    """Scale contours from mask space to level-0 pixel space (float then int32 cast,
    truncation toward zero — matching the reference's astype chain at
    utils/contours.py:119-131)."""
    out: list[np.ndarray] = []
    for c in contours:
        cf = np.asarray(c, dtype=np.float32).reshape(-1, 1, 2).copy()
        cf[:, :, 0] *= sx
        cf[:, :, 1] *= sy
        out.append(cf.astype(np.int32))
    return out


def grid_candidates(contour: np.ndarray, step: int) -> tuple[np.ndarray, np.ndarray]:
    """Row-major (y-outer, x-inner) grid anchors over the contour bounding box.

    Matches the nested range() scan of the reference (extraction.py:94-97):
    y in range(y0, y0+h, step), x in range(x0, x0+w, step).
    """
    from atlaspatch_tpu_torch.ops.polygon import bounding_rect

    x0, y0, ww, hh = bounding_rect(contour)
    xs = np.arange(x0, x0 + ww, step, dtype=np.int64)
    ys = np.arange(y0, y0 + hh, step, dtype=np.int64)
    gx, gy = np.meshgrid(xs, ys)  # shape (len(ys), len(xs))
    return gx.ravel(), gy.ravel()


def containment_mask(
    contour: np.ndarray,
    holes: list[np.ndarray],
    xs: np.ndarray,
    ys: np.ndarray,
    *,
    patch_size: int,
    center_shift: float = 0.5,
) -> np.ndarray:
    """Vectorized reference containment decision for all (xs, ys) anchors.

    Accept anchor iff (a) its patch center is not strictly inside any hole and
    (b) any of the 4 shifted probes (or the center when shift==0) is inside or
    on the tissue contour.
    """
    xs = np.asarray(xs, dtype=np.int64)
    ys = np.asarray(ys, dtype=np.int64)
    half = patch_size // 2
    cx = xs + half
    cy = ys + half
    centers = np.stack([cx, cy], axis=1)

    shift = int(half * center_shift)
    if shift > 0:
        offsets = [(-shift, -shift), (shift, shift), (shift, -shift), (-shift, shift)]
    else:
        offsets = [(0, 0)]

    inside_any = np.zeros(xs.shape[0], dtype=bool)
    for dx, dy in offsets:
        probes = np.stack([cx + dx, cy + dy], axis=1)
        inside_any |= point_polygon_test(contour, probes) >= 0

    for hole in holes:
        inside_any &= ~(point_polygon_test(hole, centers) > 0)

    return inside_any
