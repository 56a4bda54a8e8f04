"""Overlay renderers for masks, patch grids, and contours (reference parity:
atlas_patch/utils/visualization/); each submodule draws one overlay type on a
slide thumbnail and returns the written path. A copy of the JAX package's
``utils/visualization`` (host PIL code), over this package's IWSI and contours."""

from atlaspatch_tpu_torch.utils.visualization.contours import visualize_contours_on_thumbnail
from atlaspatch_tpu_torch.utils.visualization.mask import visualize_mask_on_thumbnail
from atlaspatch_tpu_torch.utils.visualization.patches import visualize_patches_on_thumbnail

__all__ = [
    "visualize_contours_on_thumbnail",
    "visualize_mask_on_thumbnail",
    "visualize_patches_on_thumbnail",
]
