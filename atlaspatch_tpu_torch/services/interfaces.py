"""Structural typing seams between the orchestration layer and the services.

The runner only ever talks to these shapes, never to concrete classes, so any
stage can be swapped out — a fake segmenter in tests, a custom loader from a
plugin — without touching orchestration code. Everything here is a
``typing.Protocol``: conformance is structural, and implementations may (but
need not) inherit from these classes for documentation value.

Behavioral contract mirrors the reference's service seams
(atlas_patch/services/interfaces.py), re-expressed as protocols.
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np

from atlaspatch_tpu_torch.core.models import ExtractionResult, Mask, Slide
from atlaspatch_tpu_torch.io.iwsi import IWSI


@runtime_checkable
class WSILoader(Protocol):
    """Opens a :class:`Slide` descriptor into a live pyramid handle."""

    def open(self, slide: Slide) -> IWSI: ...


@runtime_checkable
class MPPResolver(Protocol):
    """Supplies a microns-per-pixel override for a slide, or ``None``."""

    def resolve(self, slide: Slide) -> float | None: ...


class SegmentationService(Protocol):
    """Produces tissue masks from slide thumbnails.

    ``segment_batch`` is the hot path — implementations are expected to batch
    thumbnails onto the accelerator; ``segment_thumbnail`` is the single-slide
    convenience wrapper.
    """

    def segment_thumbnail(self, wsi: IWSI) -> Mask: ...

    def segment_batch(self, wsis: Sequence[IWSI]) -> list[Mask]: ...


class ExtractionService(Protocol):
    """Turns a tissue mask into patch-grid coordinates persisted to H5."""

    def extract(
        self, wsi: IWSI, mask: np.ndarray, *, slide: Slide
    ) -> ExtractionResult: ...


class FeatureEmbeddingService(Protocol):
    """Appends encoder features for a slide's already-extracted patches."""

    def embed_features(
        self, result: ExtractionResult, *, wsi: IWSI
    ) -> ExtractionResult: ...


class VisualizationService(Protocol):
    """Writes overlay images (mask / grid / contours) for a finished slide.

    Must not raise for individual overlay failures; visualization is
    best-effort and never fails the slide.
    """

    def visualize(
        self, result: ExtractionResult, *, wsi: IWSI, mask: np.ndarray
    ) -> None: ...
