"""AtlasPatch on PyTorch and CUDA: the port of ``atlaspatch_tpu`` to an NVIDIA H100.

The JAX package ``atlaspatch_tpu`` stays the reference; this package mirrors
its layout module for module and imports nothing of it (nor of JAX/Flax).
Slice 1 covers the ``segment-and-get-coords`` device path and its geometry:

  core/           config dataclasses (torch device strings) and domain models
  io/             WSI abstraction, synthetic slide, native contour bindings
  ops/            attention (hand-written CUDA kernel + plain version),
                  polygon containment, contours
  models/sam2     SAM2 hiera-tiny in torch + checkpoint / Flax-tree converter
  services/       SAM2 segmentation service, patch-coordinate extraction
  csrc/           CUDA and C++ sources, built at first use into _build/

Entry points run on the card (device "cuda") unless the caller asks for "cpu".
"""

__version__ = "0.1.0"
