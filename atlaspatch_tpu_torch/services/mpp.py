"""Per-slide microns-per-pixel overrides from a user CSV.

A ``wsi,mpp`` CSV (see :func:`atlaspatch_tpu_torch.utils.params.load_mpp_csv`) maps
slide stems to MPP values; slides without a row fall back to whatever the WSI
backend reads from file metadata. Behavior parity: atlas_patch/services/mpp.py.
"""

from __future__ import annotations

import pathlib

from atlaspatch_tpu_torch.core.models import Slide
from atlaspatch_tpu_torch.utils.params import load_mpp_csv


class CSVMPPResolver:
    """MPPResolver backed by a stem→mpp table loaded once at construction.

    Constructed with ``None`` (no CSV given) it resolves nothing, letting the
    backend's own metadata win everywhere.
    """

    def __init__(self, csv_path=None) -> None:
        self._overrides: dict[str, float] = {}
        if csv_path is not None:
            self._overrides = load_mpp_csv(str(csv_path))

    def resolve(self, slide: Slide) -> float | None:
        return self._overrides.get(pathlib.Path(slide.path).stem)
