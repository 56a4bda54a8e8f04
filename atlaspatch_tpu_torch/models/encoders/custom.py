"""Custom-encoder plugin system.

The port of ``atlaspatch_tpu/models/encoders/custom.py``, with the same
extension contract as the reference (reference: atlas_patch/models/patch/
custom.py:46-146): a plugin module exposes
``register_feature_extractors(registry, device, dtype, num_workers)`` and calls
``register_custom_encoder`` with a loader. The loader returns PyTorch
components, as the reference's do: an ``nn.Module`` (or any callable) mapping
a (B, 3, H, W) float tensor of normalized images in the compute dtype, on the
requested device, to (B, D) features, and the preprocessing spec. (The JAX
package's loaders return an apply function and params instead.) The module
runs inside the batched engine, ``TorchFeatureExtractor``.
"""

from __future__ import annotations

import importlib.util
import logging
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Protocol

import torch
from torch import nn

from atlaspatch_tpu_torch.models.encoders.engine import PreprocessSpec, TorchFeatureExtractor
from atlaspatch_tpu_torch.models.encoders.registry import FeatureExtractor, PatchFeatureExtractorRegistry

logger = logging.getLogger("atlaspatch_tpu_torch.models.encoders.custom")


@dataclass
class CustomEncoderComponents:
    """Bundle returned by a custom loader: the encoder (an ``nn.Module`` or a
    callable on a (B, 3, H, W) float tensor) and its preprocessing."""

    preprocess: PreprocessSpec
    model: nn.Module | Callable[[torch.Tensor], torch.Tensor]


class CustomEncoderLoader(Protocol):
    def __call__(self, device, dtype) -> CustomEncoderComponents: ...


class _ChannelsFirst(nn.Module):
    """Hands the engine's (B, H, W, 3) images to a plugin as (B, 3, H, W)."""

    def __init__(self, model: nn.Module | Callable[[torch.Tensor], torch.Tensor]) -> None:
        super().__init__()
        self.model = model  # an nn.Module becomes a submodule (moved and cast with this one)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images.permute(0, 3, 1, 2))


def register_custom_encoder(
    *,
    registry: PatchFeatureExtractorRegistry,
    name: str,
    embedding_dim: int,
    loader: CustomEncoderLoader,
    device=None,
    dtype: str = "float32",
    num_workers: int = 0,
    non_blocking: bool = False,
) -> None:
    del num_workers, non_blocking  # host threads and copies are the engine's

    def _builder() -> FeatureExtractor:
        components = loader(device, dtype)
        if not isinstance(components, CustomEncoderComponents):
            raise TypeError(
                f"Custom encoder loader for '{name}' must return CustomEncoderComponents, "
                f"got {type(components)}."
            )
        if not callable(components.model):
            raise ValueError(f"Custom encoder '{name}' must provide a model (an nn.Module or callable).")
        return TorchFeatureExtractor(
            name=name,
            embedding_dim=int(embedding_dim),
            spec=components.preprocess,
            model=_ChannelsFirst(components.model),
            device=str(device or "cuda"),
            compute_dtype="bfloat16" if str(dtype).lower().startswith("b") else "float32",
        )

    registry.register(name, _builder)


def _import_module(module_path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_path.stem, module_path)
    if spec is None or spec.loader is None:
        raise RuntimeError(f"Failed to load module spec from {module_path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def register_feature_extractors_from_module(
    module_path: str | Path,
    registry: PatchFeatureExtractorRegistry,
    *,
    device=None,
    dtype: str = "float32",
    num_workers: int = 0,
) -> None:
    """Import a plugin module and invoke its registration hook."""
    path = Path(module_path).expanduser().resolve()
    module = _import_module(path)
    hook = getattr(module, "register_feature_extractors", None)
    if not callable(hook):
        raise AttributeError(
            f"Custom encoder module {path} must define a callable "
            "'register_feature_extractors(registry, device, dtype, num_workers)'."
        )
    logger.info("Registering custom feature extractors from %s", path)
    hook(registry=registry, device=device, dtype=dtype, num_workers=num_workers)
