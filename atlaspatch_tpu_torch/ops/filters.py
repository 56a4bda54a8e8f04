"""Batched patch content filters on tensors.

The port of ``atlaspatch_tpu/ops/filters.py``: the black/white heuristics of
``utils/image.py`` (reference: atlas_patch/utils/image.py:7-38) for a whole
uint8 patch batch as integer reductions, in OpenCV's fixed-point arithmetic
(int32, and int64 for the saturation product), so the decisions equal the
host path's and cv2's. On whichever device the batch lies: the card, or the
CPU (``content_filter_mask_host`` takes ``device``).
"""

from __future__ import annotations

import numpy as np
import torch

from atlaspatch_tpu_torch.utils.image import _B2Y, _G2Y, _GRAY_SHIFT, _HSV_SHIFT, _R2Y, _SDIV_TABLE


def gray_u8(batch_u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 → (N, H, W) uint8 gray, OpenCV integer rounding."""
    p = batch_u8.to(torch.int32)
    y = (p[..., 0] * _R2Y + p[..., 1] * _G2Y + p[..., 2] * _B2Y + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
    return y.to(torch.uint8)


def sat_val_u8(batch_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, 3) uint8 → (saturation, value) uint8 channels of cv2 HSV."""
    p = batch_u8.to(torch.int32)
    v = p.amax(dim=-1)
    diff = v - p.amin(dim=-1)
    table = torch.as_tensor(_SDIV_TABLE, dtype=torch.int64, device=batch_u8.device)
    s = (diff.to(torch.int64) * table[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    return s.to(torch.uint8), v.to(torch.uint8)


def content_filter_mask(
    batch_u8: torch.Tensor,
    *,
    rgb_thresh: int = 40,  # defaults mirror utils.image.is_black_patch /
    sat_thresh: int = 5,  # is_white_patch so both paths decide identically
    value_thresh: int = 200,
    min_fraction: float = 0.7,
) -> torch.Tensor:
    """(N, H, W, 3) uint8 → (N,) bool KEEP mask (not black and not white).
    The fractions are float32, as the reference's are."""
    n_pix = batch_u8.shape[1] * batch_u8.shape[2]
    limit = torch.tensor(min_fraction, dtype=torch.float32, device=batch_u8.device)
    black = (gray_u8(batch_u8) < rgb_thresh).sum(dim=(1, 2), dtype=torch.int32)
    s, v = sat_val_u8(batch_u8)
    white = ((s < sat_thresh) & (v >= value_thresh)).sum(dim=(1, 2), dtype=torch.int32)
    return (black.float() / n_pix < limit) & (white.float() / n_pix < limit)


def content_filter_mask_host(batch_u8: np.ndarray, *, device: str = "cuda", **kw) -> np.ndarray:
    """``content_filter_mask`` of a host batch on ``device``; a numpy bool mask."""
    return content_filter_mask(torch.from_numpy(np.asarray(batch_u8)).to(device), **kw).cpu().numpy()
