"""Slide access: the WSI abstraction, the backend factory, plain-image,
synthetic and pyramid readers (native TIFF/SVS/NDPI/SCN/BIF decode, MIRAX,
Hamamatsu VMS/VMU, DICOM WSI), and the native geometry and decode bindings."""

from atlaspatch_tpu_torch.io.dicom_wsi import DicomWSI
from atlaspatch_tpu_torch.io.factory import UnsupportedFormatError, WSIFactory
from atlaspatch_tpu_torch.io.hamamatsu_wsi import HamamatsuVMSWSI, HamamatsuVMUWSI
from atlaspatch_tpu_torch.io.image_wsi import ImageWSI
from atlaspatch_tpu_torch.io.iwsi import IWSI
from atlaspatch_tpu_torch.io.mirax_wsi import MiraxWSI
from atlaspatch_tpu_torch.io.tiff_wsi import TiffWSI

__all__ = [
    "IWSI",
    "DicomWSI",
    "HamamatsuVMSWSI",
    "HamamatsuVMUWSI",
    "ImageWSI",
    "MiraxWSI",
    "TiffWSI",
    "UnsupportedFormatError",
    "WSIFactory",
]
