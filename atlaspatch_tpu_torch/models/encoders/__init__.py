"""Patch encoders: the registry, the ViT, ResNet, ConvNeXt, Swin, CLIP
ModifiedResNet, CoCa and BEiT3 towers with their checkpoint converters, the
plugin loader, the batched engine and the zoo."""

from atlaspatch_tpu_torch.models.encoders.registry import PatchFeatureExtractorRegistry
from atlaspatch_tpu_torch.models.encoders.zoo import build_default_registry

__all__ = [
    "PatchFeatureExtractorRegistry",
    "build_default_registry",
]
