"""Patch content heuristics (black / white filtering).

Behavior parity with the reference filters (reference: atlas_patch/utils/image.py:
7-38), which delegate color conversion to OpenCV. To keep coordinates
bit-identical without an OpenCV dependency on the hot path, the uint8 RGB→GRAY
and RGB→HSV(S,V) conversions are reimplemented here with OpenCV's exact
fixed-point integer arithmetic (verified against cv2 in tests), as pure numpy.
"""

from __future__ import annotations

import numpy as np

# OpenCV 8-bit RGB->GRAY fixed-point coefficients (shift 15; verified exhaustively
# against cv2 5.0 over all 2^24 RGB values).
_R2Y, _G2Y, _B2Y = 9798, 19235, 3735
_GRAY_SHIFT = 15

# OpenCV 8-bit HSV saturation table shift.
_HSV_SHIFT = 12
# sdiv_table[v] = cvRound((255 << 12) / v) for v>0; table[0] = 0.
_SDIV_TABLE = np.zeros(256, dtype=np.int64)
_SDIV_TABLE[1:] = np.floor((255 << _HSV_SHIFT) / np.arange(1, 256) + 0.5).astype(np.int64)


def rgb_to_gray_u8(patch: np.ndarray) -> np.ndarray:
    """uint8 RGB → uint8 gray with OpenCV's integer rounding."""
    p = patch.astype(np.int64)
    y = (
        p[..., 0] * _R2Y + p[..., 1] * _G2Y + p[..., 2] * _B2Y + (1 << (_GRAY_SHIFT - 1))
    ) >> _GRAY_SHIFT
    return y.astype(np.uint8)


def rgb_to_sat_val_u8(patch: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 RGB → (saturation, value) channels of OpenCV's 8-bit HSV."""
    p = patch.astype(np.int64)
    v = p.max(axis=-1)
    vmin = p.min(axis=-1)
    diff = v - vmin
    s = (diff * _SDIV_TABLE[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    return s.astype(np.uint8), v.astype(np.uint8)


def is_black_patch(patch: np.ndarray, rgb_thresh: int = 40, min_fraction: float = 0.7) -> bool:
    """True when >= min_fraction of pixels have gray level < rgb_thresh."""
    if patch.ndim == 3 and patch.shape[2] == 3:
        gray = rgb_to_gray_u8(patch)
    else:
        gray = patch.astype(np.uint8)
    frac = float((gray < rgb_thresh).mean())
    return bool(frac >= float(min_fraction))


def is_white_patch(
    patch: np.ndarray,
    sat_thresh: int = 5,
    min_fraction: float = 0.7,
    value_thresh: int = 200,
) -> bool:
    """True when >= min_fraction of pixels are low-saturation AND bright."""
    s, v = rgb_to_sat_val_u8(patch)
    mask = (s < sat_thresh) & (v >= value_thresh)
    frac = float(mask.mean())
    return bool(frac >= float(min_fraction))
