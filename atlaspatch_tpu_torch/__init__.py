"""AtlasPatch on PyTorch and CUDA: the port of ``atlaspatch_tpu`` to an NVIDIA H100.

The JAX package ``atlaspatch_tpu`` stays the reference; this package mirrors
its layout module for module and imports nothing of it (nor of JAX/Flax).
It covers ``segment-and-get-coords`` from slides to H5 files, and ``process``'s
patch feature embedding into them (below the CLI, which is not ported yet):

  core/           config dataclasses (torch device strings), domain models,
                  the output-path contract
  io/             WSI abstraction, backend factory, the slide readers (native
                  TIFF/SVS/NDPI/SCN/BIF decode, MIRAX, Hamamatsu VMS/VMU,
                  DICOM WSI), plain-image and synthetic slides, native
                  decode and contour bindings
  ops/            attention (hand-written CUDA kernel + plain version),
                  polygon containment, contours
  models/sam2     SAM2 hiera-tiny in torch + checkpoint / Flax-tree converter
  models/encoders the encoder zoo (66 names; the ViT family builds), the
                  batched embedding engine, converters
  parallel/       multi-host work sharding
  services/       SAM2 segmentation, patch-coordinate extraction, H5 storage
                  and feature appends, feature embedding, slide loading, MPP
                  overrides
  orchestration/  the runner: discovery, skip, locks, pipelined segmentation,
                  extraction thread pool
  utils/          the port's own HDF5 writer and reader, stage counters,
                  discovery, content filters, feature-completeness probes
  csrc/           CUDA and C++ sources (and vendored libjpeg headers), built
                  at first use into _build/

Entry points run on the card (device "cuda") unless the caller asks for "cpu".
"""

from atlaspatch_tpu_torch import core, services  # noqa: F401  (the JAX package's interface: core + services)

__version__ = "0.1.0"
__all__ = ["core", "services", "__version__"]
