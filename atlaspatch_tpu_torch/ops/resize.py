"""Image resizing ops on tensors.

The port of ``atlaspatch_tpu/ops/resize.py``: it re-exports the
torch-semantics interpolation of the SAM2 path (models/sam2/interp.py holds
the math) and adds the nearest-neighbour resize.
"""

from __future__ import annotations

import torch

from atlaspatch_tpu_torch.models.sam2.interp import interpolate_torch  # noqa: F401


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, H, W[, C]) nearest-neighbour resize with the half-pixel mapping
    floor((i + 0.5) * scale). The index is computed in float32, the scale
    H / out_h rounded to float32 first, as the reference computes it; float64
    gives other indices at some ratios."""
    H, W = x.shape[1], x.shape[2]
    out_h, out_w = out_hw

    def index(n_in: int, n_out: int) -> torch.Tensor:
        scale = torch.tensor(n_in / n_out, dtype=torch.float32)
        i = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * scale).to(torch.int32)
        return i.clamp(0, n_in - 1).to(device=x.device, dtype=torch.long)

    return x[:, index(H, out_h)][:, :, index(W, out_w)]
