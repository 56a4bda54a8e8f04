"""On-disk layout of a run — the compatibility contract with downstream MIL.

Everything lives under one run root (``OutputConfig.output_root``):

    patches/<stem>.h5     per-slide HDF5 (coords + passports + features/*)
    patches/<stem>.lock   cross-process work lock (O_CREAT|O_EXCL)
    images/<stem>/        optional per-patch PNG exports

Layout parity: atlas_patch/core/paths.py:9-42. The module-level functions are
the stable API; :class:`RunLayout` is the single place the directory names are
actually spelled.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from atlaspatch_tpu_torch.core.config import ExtractionConfig, OutputConfig
from atlaspatch_tpu_torch.core.models import Slide


@dataclass(frozen=True)
class RunLayout:
    """Resolves every output location for a run rooted at ``root``."""

    root: Path

    @property
    def patches(self) -> Path:
        return self.root / "patches"

    def h5_for(self, stem: str) -> Path:
        return self.patches / f"{stem}.h5"

    def lock_for(self, stem: str) -> Path:
        return self.patches / f"{stem}.lock"

    def images_for(self, stem: str) -> Path:
        return self.root / "images" / stem


def _layout(output_cfg: OutputConfig) -> RunLayout:
    return RunLayout(Path(output_cfg.output_root))


def build_run_root(output_cfg: OutputConfig, extraction_cfg: ExtractionConfig) -> Path:
    return _layout(output_cfg).root


def patch_h5_path(
    slide: Slide, output_cfg: OutputConfig, extraction_cfg: ExtractionConfig
) -> Path:
    return _layout(output_cfg).h5_for(slide.stem)


def patch_lock_path(
    slide: Slide, output_cfg: OutputConfig, extraction_cfg: ExtractionConfig
) -> Path:
    return _layout(output_cfg).lock_for(slide.stem)


def images_dir(
    slide: Slide, output_cfg: OutputConfig, extraction_cfg: ExtractionConfig
) -> Path:
    return _layout(output_cfg).images_for(slide.stem)


def find_existing_patch(
    slide: Slide, output_cfg: OutputConfig, extraction_cfg: ExtractionConfig
) -> Path | None:
    """The slide's H5 if one is already on disk, else ``None``."""
    h5 = patch_h5_path(slide, output_cfg, extraction_cfg)
    return h5 if h5.exists() else None
