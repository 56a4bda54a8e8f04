"""Torch-interpolate image resizing as static weight matrices.

torch.nn.functional.interpolate(mode="bicubic"/"bilinear", align_corners=False)
uses half-pixel source mapping with border clamping; bicubic uses the cubic
convolution kernel with a = -0.75. The 1-D interpolation weights are built
with numpy (float64, cast to float32) and applied as two float32 einsums, the
same arithmetic as the JAX package's ``interpolate_torch``. ``F.interpolate``
is not used: its kernels sum the taps in another order, and the weight-matrix
form keeps the thresholded mask bits reproducible against the reference.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )
    return w


@lru_cache(maxsize=64)
def _interp_weights_1d(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """(out_size, in_size) dense weight matrix for torch interpolate (no antialias)."""
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    W = np.zeros((out_size, in_size), dtype=np.float64)
    if mode == "bilinear":
        i0 = np.floor(src).astype(np.int64)
        frac = src - i0
        for tap, weight in ((i0, 1 - frac), (i0 + 1, frac)):
            idx = np.clip(tap, 0, in_size - 1)
            np.add.at(W, (np.arange(out_size), idx), weight)
    elif mode == "bicubic":
        i0 = np.floor(src).astype(np.int64)
        frac = src - i0
        for k in range(-1, 3):
            tap = i0 + k
            weight = _cubic_kernel(frac - k)
            idx = np.clip(tap, 0, in_size - 1)
            np.add.at(W, (np.arange(out_size), idx), weight)
    else:
        raise ValueError(f"unsupported mode {mode}")
    W = W.astype(np.float32)
    W.flags.writeable = False  # cached: shared by every caller
    return W


def interpolate_torch(x: torch.Tensor, out_hw: tuple[int, int], mode: str) -> torch.Tensor:
    """Resize (B, H, W, C) with torch-interpolate semantics (align_corners=False,
    antialias=False), computed in float32 and returned in x's dtype. `mode` is
    "bilinear" or "bicubic"."""
    B, H, W, C = x.shape
    out_h, out_w = out_hw
    if (H, W) == (out_h, out_w):
        return x
    Wh = torch.from_numpy(_interp_weights_1d(H, out_h, mode).copy()).to(x.device)
    Ww = torch.from_numpy(_interp_weights_1d(W, out_w, mode).copy()).to(x.device)
    y = torch.einsum("oh,bhwc->bowc", Wh, x.float())
    y = torch.einsum("ow,bhwc->bhoc", Ww, y)
    return y.to(x.dtype)
