"""Patch coordinates from a tissue mask, the upstream AtlasPatch way: OpenCV
contours and one ``pointPolygonTest`` per probe.

Semantics (the upstream ``utils/contours.py`` and ``services/extraction.py``):
CCOMP contours of the binary mask; an outer contour is tissue when its area
is at least ``tissue_threshold`` of the mask's; a hole (a child) counts when
its area is at least 16 px, the 10 largest over the slide kept; contours are
scaled to level 0 by (W0 / mask_w, H0 / mask_h) in float32 and cast to
int32; each tissue contour's bounding box is scanned row by row at the step,
and an anchor is kept when any of four probes at the patch centre
± (patch // 2) // 2 lies in or on the contour and the centre lies strictly
inside none of its holes.
"""

from __future__ import annotations

import numpy as np

A_HOLE = 16
MAX_HOLES = 10


def contours(mask: np.ndarray, tissue_threshold: float):
    """(tissue contours, holes per tissue contour) in mask pixels."""
    import cv2

    found, hierarchy = cv2.findContours((mask > 0).astype(np.uint8) * 255, cv2.RETR_CCOMP, cv2.CHAIN_APPROX_NONE)
    if not found:
        return [], []
    parents = hierarchy[0][:, 3]
    min_area = tissue_threshold * float(mask.shape[0] * mask.shape[1])
    tissue = [i for i, c in enumerate(found) if parents[i] == -1 and cv2.contourArea(c) >= min_area]
    holes = [i for i, c in enumerate(found) if parents[i] != -1 and cv2.contourArea(c) >= A_HOLE]
    if len(holes) > MAX_HOLES:
        by_parent: dict[int, list[int]] = {}  # ties at the cut go to the parent seen first
        for i in holes:
            by_parent.setdefault(int(parents[i]), []).append(i)
        ordered = [i for group in by_parent.values() for i in group]
        keep = set(sorted(ordered, key=lambda i: cv2.contourArea(found[i]), reverse=True)[:MAX_HOLES])
        holes = [i for i in holes if i in keep]
    return ([found[i] for i in tissue],
            [[found[h] for h in holes if parents[h] == t] for t in tissue])


def scale(contour: np.ndarray, sx: float, sy: float) -> np.ndarray:
    c = np.asarray(contour, dtype=np.float32).reshape(-1, 1, 2).copy()
    c[:, :, 0] *= sx
    c[:, :, 1] *= sy
    return c.astype(np.int32)


def coordinates(mask: np.ndarray, level0_wh: tuple[int, int], *, patch: int, step: int,
                tissue_threshold: float) -> np.ndarray:
    """(N, 2) int64 level-0 anchors (x, y) in scan order."""
    import cv2

    tissue, holes = contours(mask, tissue_threshold)
    sx, sy = level0_wh[0] / float(mask.shape[1]), level0_wh[1] / float(mask.shape[0])
    half = patch // 2
    shift = int(half * 0.5)
    probes = [(-shift, -shift), (shift, shift), (shift, -shift), (-shift, shift)]
    out = []
    for t, hs in zip(tissue, holes):
        t = scale(t, sx, sy)
        hs = [scale(h, sx, sy) for h in hs]
        x0, y0, w, h = cv2.boundingRect(t)
        for y in range(y0, y0 + h, step):
            for x in range(x0, x0 + w, step):
                cx, cy = x + half, y + half
                if not any(cv2.pointPolygonTest(t, (float(cx + dx), float(cy + dy)), False) >= 0
                           for dx, dy in probes):
                    continue
                if any(cv2.pointPolygonTest(hole, (float(cx), float(cy)), False) > 0 for hole in hs):
                    continue
                out.append((x, y))
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)
