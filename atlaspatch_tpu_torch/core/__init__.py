"""Config dataclasses + domain models (the reference's public core surface)."""

from atlaspatch_tpu_torch.core.config import (
    AppConfig,
    ExtractionConfig,
    FeatureExtractionConfig,
    OutputConfig,
    ProcessingConfig,
    SegmentationConfig,
    VisualizationConfig,
)
from atlaspatch_tpu_torch.core.models import ExtractionResult, Mask, Slide

__all__ = [
    "AppConfig",
    "ExtractionConfig",
    "FeatureExtractionConfig",
    "OutputConfig",
    "ProcessingConfig",
    "SegmentationConfig",
    "VisualizationConfig",
    "ExtractionResult",
    "Mask",
    "Slide",
]
