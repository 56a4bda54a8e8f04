"""Lazy name→builder registry for patch encoders.

Builders are zero-arg callables so that registering all 66 zoo names costs
nothing until an encoder is actually requested — weights load at
:meth:`PatchFeatureExtractorRegistry.create` time, once per name.
API parity: atlas_patch/models/patch/registry.py + base.py's extractor ABC.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

logger = logging.getLogger("atlaspatch_tpu_torch.models.encoders")


class FeatureExtractor(ABC):
    """Patch-level feature extractor: batches of HWC uint8 → (N, D) float32."""

    name: str
    embedding_dim: int

    @abstractmethod
    def extract_batch(
        self, patches: Sequence[np.ndarray], *, batch_size: int | None = None
    ) -> np.ndarray: ...

    @abstractmethod
    def cleanup(self) -> None: ...


Builder = Callable[[], FeatureExtractor]


class PatchFeatureExtractorRegistry:
    """Case-insensitive registry; duplicate registration is a hard error."""

    def __init__(self) -> None:
        self._builders: dict[str, Builder] = {}

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._builders

    def __len__(self) -> int:
        return len(self._builders)

    def register(self, name: str, builder: Builder) -> None:
        if name in self:
            raise ValueError(f"Feature extractor '{name}' already registered.")
        self._builders[name.lower()] = builder

    def available(self) -> list[str]:
        return sorted(self._builders)

    def create(self, name: str) -> FeatureExtractor:
        builder = self._builders.get(name.lower())
        if builder is None:
            raise KeyError(
                f"Unknown feature extractor '{name}'. Available: {self.available()}"
            )
        try:
            return builder()
        except Exception:
            logger.exception("Failed to create feature extractor '%s'", name)
            raise

    def create_many(self, names: Iterable[str]) -> list[FeatureExtractor]:
        return [self.create(n) for n in names]

    def as_mapping(self) -> Mapping[str, Builder]:
        return dict(self._builders)
