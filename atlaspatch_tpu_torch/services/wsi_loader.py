"""Default WSI loader delegating to the factory
(reference: atlas_patch/services/wsi_loader.py:8-12)."""

from __future__ import annotations

from atlaspatch_tpu_torch.core.models import Slide
from atlaspatch_tpu_torch.io.factory import WSIFactory
from atlaspatch_tpu_torch.services.interfaces import WSILoader
from atlaspatch_tpu_torch.utils import perf


class DefaultWSILoader(WSILoader):
    def open(self, slide: Slide):
        with perf.stage("wsi_open"):
            return WSIFactory.load(str(slide.path), mpp=slide.mpp, backend=slide.backend)
