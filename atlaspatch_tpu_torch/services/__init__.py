"""Service layer: SAM2 segmentation, patch-coordinate extraction and storage,
patch feature embedding, slide loading and MPP overrides."""

from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
from atlaspatch_tpu_torch.services.feature_embedding import PatchFeatureEmbeddingService
from atlaspatch_tpu_torch.services.mpp import CSVMPPResolver
from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService
from atlaspatch_tpu_torch.services.storage import H5PatchWriter
from atlaspatch_tpu_torch.services.wsi_loader import DefaultWSILoader

__all__ = [
    "CSVMPPResolver",
    "DefaultWSILoader",
    "H5PatchWriter",
    "PatchExtractionService",
    "PatchFeatureEmbeddingService",
    "SAM2SegmentationService",
]
