"""Service layer: SAM2 segmentation and patch-coordinate extraction."""

from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService

__all__ = ["PatchExtractionService", "SAM2SegmentationService"]
