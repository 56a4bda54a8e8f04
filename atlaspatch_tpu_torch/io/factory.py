"""Extension → backend registry (reference: atlas_patch/core/wsi/wsi_factory.py:12-141).

The JAX package routes pyramidal formats to its native TIFF decoder and its
MIRAX, Hamamatsu and DICOM readers, and plain images to ImageWSI. The port
has ImageWSI only so far: the other backends keep their names and
extensions, and opening one raises :class:`UnsupportedFormatError` naming the
reader as not yet ported (the runner records that as the slide's failure).
Runtime registration of new backends/extensions is preserved.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from atlaspatch_tpu_torch.io.image_wsi import ImageWSI
from atlaspatch_tpu_torch.io.iwsi import IWSI


class UnsupportedFormatError(ValueError):
    """The file's container format is recognized but not decodable by the port."""


def _not_ported(backend: str, reader: str):
    def factory():
        raise UnsupportedFormatError(
            f"the {backend} backend ({reader} in the JAX package) is not yet ported to "
            "atlaspatch_tpu_torch; register a custom backend via WSIFactory.register()"
        )

    return factory


_tiff_backend = _not_ported("tiff", "io/tiff_wsi.py")
_mirax_backend = _not_ported("mirax", "io/mirax_wsi.py")
_vms_backend = _not_ported("vms", "io/hamamatsu_wsi.py")
_vmu_backend = _not_ported("vmu", "io/hamamatsu_wsi.py")
_dicom_backend = _not_ported("dicom", "io/dicom_wsi.py")

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

    # TIFF-container formats (classic TIFF / BigTIFF internals): Aperio .svs,
    # Hamamatsu .ndpi, Leica .scn, Ventana .bif/.biff, Trestle/plain/OME .tif.
    # Non-TIFF containers: MIRAX (.mrxs), Hamamatsu map files (.vms/.vmu),
    # DICOM WSI (.dcm).
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
