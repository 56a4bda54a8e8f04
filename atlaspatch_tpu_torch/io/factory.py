"""Extension → backend registry (reference: atlas_patch/core/wsi/wsi_factory.py:12-141).

Pyramidal formats route to the native TIFF backend (the port's C++ decoder,
io/tiff_wsi.py) instead of OpenSlide, and MIRAX, Hamamatsu VMS/VMU and DICOM
WSI to their first-party readers; plain-image formats route to ImageWSI.
Runtime registration of new backends/extensions is preserved.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from atlaspatch_tpu_torch.io.image_wsi import ImageWSI
from atlaspatch_tpu_torch.io.iwsi import IWSI


class UnsupportedFormatError(ValueError):
    """The file's container format is recognized but not decodable natively."""


def _tiff_backend():
    from atlaspatch_tpu_torch.io.tiff_wsi import TiffWSI

    return TiffWSI


def _mirax_backend():
    from atlaspatch_tpu_torch.io.mirax_wsi import MiraxWSI

    return MiraxWSI


def _vms_backend():
    from atlaspatch_tpu_torch.io.hamamatsu_wsi import HamamatsuVMSWSI

    return HamamatsuVMSWSI


def _vmu_backend():
    from atlaspatch_tpu_torch.io.hamamatsu_wsi import HamamatsuVMUWSI

    return HamamatsuVMUWSI


def _dicom_backend():
    from atlaspatch_tpu_torch.io.dicom_wsi import DicomWSI

    return DicomWSI


class WSIFactory:
    """WSI loader with backend selection."""

    _registry: dict[str, object] = {
        # lazy factories resolve to their class on first use
        "tiff": _tiff_backend,
        "mirax": _mirax_backend,
        "vms": _vms_backend,
        "vmu": _vmu_backend,
        "dicom": _dicom_backend,
        "image": ImageWSI,
    }
    _lazy = {_tiff_backend, _mirax_backend, _vms_backend, _vmu_backend, _dicom_backend}

    # TIFF-container formats (classic TIFF / BigTIFF internals) decode via the
    # native C++ decoder: Aperio .svs, Hamamatsu .ndpi, Leica .scn, Ventana
    # .bif/.biff, Trestle/plain/OME .tif. Non-TIFF containers have first-party
    # readers: MIRAX (.mrxs), Hamamatsu map files (.vms/.vmu), DICOM WSI (.dcm).
    _formats = {
        ".svs": "tiff",
        ".tif": "tiff",
        ".tiff": "tiff",
        ".ndpi": "tiff",
        ".scn": "tiff",
        ".bif": "tiff",
        ".biff": "tiff",
        ".mrxs": "mirax",
        ".vms": "vms",
        ".vmu": "vmu",
        ".dcm": "dicom",
        ".dicom": "dicom",
        ".png": "image",
        ".jpg": "image",
        ".jpeg": "image",
        ".bmp": "image",
        ".webp": "image",
        ".gif": "image",
    }

    # Containers recognized but not decoded get a clear error instead of a
    # misleading parse failure. Empty, as in the JAX factory, whose refusal
    # this mirrors; see ROADMAP.md for removing it from both.
    _known_unsupported: dict[str, str] = {}

    @classmethod
    def _resolve(cls, name: str):
        impl = cls._registry[name]
        if impl in cls._lazy:
            impl = impl()
            cls._registry[name] = impl
        return impl

    @classmethod
    def register(cls, name: str, impl_class) -> None:
        cls._registry[name] = impl_class

    @classmethod
    def map_extension(cls, ext: str, backend: str) -> None:
        if backend not in cls._registry:
            raise ValueError(f"Unknown backend: {backend}")
        if not ext.startswith("."):
            ext = "." + ext
        cls._formats[ext.lower()] = backend

    @classmethod
    def detect(cls, path: str) -> Optional[str]:
        return cls._formats.get(Path(path).suffix.lower())

    @classmethod
    def load(
        cls, path: str, backend: Optional[str] = None, mpp: Optional[float] = None, **kwargs
    ) -> IWSI:
        if not os.path.exists(path):
            raise FileNotFoundError(f"File not found: {path}")
        if backend is None:
            backend = cls.detect(path)
            if backend is None:
                ext = Path(path).suffix.lower()
                if ext in cls._known_unsupported:
                    raise UnsupportedFormatError(
                        f"{ext} — {cls._known_unsupported[ext]} — is not supported "
                        "by the native decoder (no OpenSlide in this build). "
                        "Convert the slide to a TIFF-family format (.svs/.tiff) "
                        "or register a custom backend via WSIFactory.register()."
                    )
                raise ValueError(f"No backend found for: {path}")
        elif backend not in cls._registry:
            raise ValueError(f"Unknown backend: {backend}")
        impl = cls._resolve(backend)
        return impl(path=path, mpp=mpp, **kwargs)

    @classmethod
    def try_load(
        cls, path: str, backends: Optional[list] = None, mpp: Optional[float] = None, **kwargs
    ) -> IWSI:
        """Try multiple backends in order until one loads."""
        if not os.path.exists(path):
            raise FileNotFoundError(f"File not found: {path}")
        if backends is None:
            backends = list(cls._registry.keys())
        errors = []
        for b in backends:
            if b not in cls._registry:
                errors.append(f"{b}: not registered")
                continue
            try:
                return cls.load(path, backend=b, mpp=mpp, **kwargs)
            except Exception as e:
                errors.append(f"{b}: {e}")
        raise RuntimeError(f"All backends failed for {path}:\n" + "\n".join(errors))
