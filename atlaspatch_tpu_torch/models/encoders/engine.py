"""Batched inference engine for patch encoders on one CUDA card (or the CPU).

The port of ``atlaspatch_tpu/models/encoders/engine.py``:

  host: per-patch PIL resize/crop to the encoder's input size (byte-identical
        to the JAX package's, kept on the host for parity with torchvision /
        transformers preprocessing) on a thread pool, overlapping device work;
  device: uint8 → float32 normalize → compute dtype → encoder forward →
        features, returned to the host as float32.

Batches are padded to power-of-two buckets ≤ ``max_batch`` (``_bucket``), as
the reference does so that it compiles few programs; here it keeps the
kernels' shapes few. Params live on the device once. In bfloat16 mode every
float32 param is cast to bfloat16 (else the matmuls would run in float32 or
mixed); in int8 mode (the W8A8 ViTs) activations flow in bfloat16 between the
int8 products, and every floating tensor but the per-channel ``qscale``
factors is cast to bfloat16 by name, as the reference casts its tree
(engine.py:138-156); in float32 mode on the card the engine turns TF32 off for
cuBLAS and cuDNN itself (process-wide, as the segmenter's float32 mode does), so float32
features are float32-exact.

The knobs are the reference's, with its names and meanings:
``ATLASPATCH_H2D_DEPTH`` (dispatches in flight, default 2),
``ATLASPATCH_DEFERRED_FETCH`` (default 1: device→host copies start at once
into pinned buffers and complete by a CUDA event; 0: blocking fetches),
``ATLASPATCH_DEFERRED_MAX_CHUNKS`` (the deferred window, default 64) and
``ATLASPATCH_FEATURE_D2H_BF16`` (features cross the link as bfloat16 and are
cast back to float32). Host stages: ``embed_prep``, ``embed_dispatch``,
``embed_d2h_start``, ``embed_fetch``.

With a ``mesh`` (``parallel/mesh.py``) batches pad to a multiple of its data
size and split contiguously over the data rows; each row holds one replica
of the encoder, or with ``tensor_parallel`` one group of shards over the
row's 'model' devices (``parallel/sharding.py::shard_vit``), in the int8
serving mode too: the replicas and shards are made after the cast, which
keeps ``qscale`` float32. Each row's features come back through its own
pinned fetch, in patch order.
"""

from __future__ import annotations

import logging
import math
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn

from atlaspatch_tpu_torch.models.encoders.registry import FeatureExtractor
from atlaspatch_tpu_torch.models.encoders.vit import pitch_int8_weights
from atlaspatch_tpu_torch.utils import perf

logger = logging.getLogger("atlaspatch_tpu_torch.models.encoders")

_PIL_INTERP = ("bilinear", "bicubic", "nearest", "lanczos")


@dataclass(frozen=True)
class PreprocessSpec:
    """Host-side geometric preprocessing + normalization constants.

    mode "square": resize directly to (crop, crop) — HF image-processor style.
    mode "shortest": resize shorter side to `resize` then center-crop `crop` —
    torchvision classification-preset / CLIP style.
    """

    crop: int = 224
    resize: int = 224
    mode: str = "square"
    interpolation: str = "bilinear"
    mean: tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: tuple[float, float, float] = (0.229, 0.224, 0.225)
    rescale: float = 1.0 / 255.0

    def apply_host(self, patch) -> np.ndarray:
        from PIL import Image

        img = patch if isinstance(patch, Image.Image) else Image.fromarray(patch)
        if img.mode != "RGB":
            img = img.convert("RGB")
        if self.interpolation not in _PIL_INTERP:
            raise KeyError(self.interpolation)
        interp = getattr(Image.Resampling, self.interpolation.upper())
        if self.mode == "square":
            if img.size != (self.crop, self.crop):
                img = img.resize((self.crop, self.crop), interp)
        elif self.mode == "shortest":
            # torchvision-exact geometry: the long side TRUNCATES
            # (int(size*long/short), _compute_resized_output_size) and the
            # crop offset uses python round() (F.center_crop)
            w, h = img.size
            short, long = (w, h) if w <= h else (h, w)
            if short != self.resize:
                new_long = max(1, int(self.resize * long / short))
                nw, nh = (self.resize, new_long) if w <= h else (new_long, self.resize)
                img = img.resize((nw, nh), interp)
            w, h = img.size
            left = int(round((w - self.crop) / 2.0))
            top = int(round((h - self.crop) / 2.0))
            img = img.crop((left, top, left + self.crop, top + self.crop))
        else:
            raise ValueError(f"unknown preprocess mode {self.mode}")
        return np.asarray(img, dtype=np.uint8)


@torch.no_grad()
def init_random_weights_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Deterministic random weights for a zoo tower from ``seed``, drawn on
    the model's device (a device's generator gives its own stream), with the
    Flax initializers' laws: truncated-normal LeCun kernels (a depthwise
    kernel's fan-in is its window), zero biases, unit LayerNorm / BatchNorm
    scales, LayerScales and layer scales, N(0, 0.02) positional embeddings,
    MAP probe, Swin position-bias tables and CoCa pooler queries, N(0, 1/C)
    for the CLIP attention pool's positional embedding, zero class and
    register tokens. Buffers (BatchNorm running statistics) keep their
    values."""
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.ndim >= 2:  # Linear / Conv kernel: fan_in of the input
            std = math.sqrt(1.0 / (p[0].numel())) / 0.87962566103423978
            nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std, generator=gen)
        elif leaf in ("pos_embed", "probe", "rel_pos_table", "query"):
            p.normal_(0.0, 0.02, generator=gen)
        elif leaf == "positional_embedding":
            p.normal_(0.0, p.shape[-1] ** -0.5, generator=gen)
        elif leaf in ("weight", "ls1", "ls2", "layer_scale"):
            p.fill_(1.0)
        else:  # biases, class and register tokens
            p.zero_()
    return model


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
        if b >= max_batch:
            return max_batch
    return b


# compute dtype -> the activations' dtype (int8: bfloat16 between the int8 products)
_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.bfloat16}
_KEEP_FLOAT32 = ("qscale",)  # int8 mode's dequantization scales stay exact


def _cast_floating_(model: nn.Module, dtype: torch.dtype, keep: tuple[str, ...] = ()) -> nn.Module:
    """Cast every floating param and buffer of ``model`` to ``dtype`` in
    place, except those whose own name is in ``keep``."""
    for module in model.modules():
        for store in (module._parameters, module._buffers):
            for name, t in store.items():
                if t is not None and t.is_floating_point() and name not in keep:
                    t.data = t.data.to(dtype)
    return model


def require_device(name: str, device: str) -> torch.device:
    """``device`` as a torch device; a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"feature extractor {name!r} asked for device {device!r}, but CUDA is "
            "not available; pass device='cpu' to run on the CPU."
        )
    return dev


class TorchFeatureExtractor(FeatureExtractor):
    """Runs an encoder ``nn.Module`` over preprocessed patch batches on one
    device, or over a mesh.

    ``model(images)`` maps (N, S, S, 3) normalized images in the compute dtype
    to (N, D) features. ``device`` is a torch device string; "cuda" without a
    card raises. ``compute_dtype`` is float32, bfloat16 or int8 (bfloat16
    activations; the model's int8 layers are the W8A8 ones). ``mesh``
    replaces ``device`` (its first device holds the first replica);
    ``tensor_parallel`` shards a ViT over each data row's 'model' devices.
    """

    def __init__(
        self,
        *,
        name: str,
        embedding_dim: int,
        spec: PreprocessSpec,
        model: nn.Module,
        device: str = "cuda",
        mesh=None,
        tensor_parallel: bool = False,
        compute_dtype: str = "float32",
        max_batch: int = 256,
        prep_workers: int = 8,
    ) -> None:
        if compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"unknown compute dtype {compute_dtype!r}")
        self.name = name
        self.embedding_dim = int(embedding_dim)
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.max_batch = int(max_batch)
        self.prep_workers = int(prep_workers)
        self.mesh = mesh
        self.device = require_device(name, str(mesh.data_devices[0]) if mesh is not None else device)
        if self.device.type == "cuda" and compute_dtype == "float32":
            # float32 features are float32-exact: no TF32 in cuBLAS, nor in
            # cuDNN (its default) for the patch-embed convolution
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        # Read once, as the reference does (its jit cache is keyed by shape only).
        self._fetch_bf16 = os.environ.get("ATLASPATCH_FEATURE_D2H_BF16", "0") == "1"
        self._dtype = _COMPUTE_DTYPES[compute_dtype]
        model = model.eval().requires_grad_(False)
        if mesh is None or not tensor_parallel:
            model = model.to(device=self.device)
        # by name, not Module.to(dtype), which would cast qscale too
        model = _cast_floating_(model, self._dtype, keep=_KEEP_FLOAT32 if compute_dtype == "int8" else ())
        if mesh is None:
            self.replicas = [model]
        elif tensor_parallel:
            from atlaspatch_tpu_torch.parallel.sharding import shard_vit

            self.replicas = shard_vit(model, mesh)
        else:
            from atlaspatch_tpu_torch.parallel.mesh import replicate

            self.replicas = replicate(mesh, model)
        for replica in self.replicas:  # on their devices now: Module.to would pack the pitched rows again
            pitch_int8_weights(replica)
        self.model = self.replicas[0]
        self._batch_align = mesh.shape["data"] if mesh is not None else 1
        self._norm = [(torch.tensor(spec.mean, dtype=torch.float32, device=d),
                       torch.tensor(spec.std, dtype=torch.float32, device=d)) for d in self._row_devices()]

    def _row_devices(self) -> list[torch.device]:
        return self.mesh.data_devices if self.mesh is not None else [self.device]

    # --- device ------------------------------------------------------------------
    def forward_device(self, images_u8: torch.Tensor, replica: int = 0) -> torch.Tensor:
        """(N, S, S, 3) uint8 on a replica's device → (N, D) features there,
        float32 (bfloat16 with ATLASPATCH_FEATURE_D2H_BF16=1); one
        ``embed_forward`` span in an ``ATLASPATCH_TORCH_TRACE`` trace."""
        mean, std = self._norm[replica]
        with torch.inference_mode(), perf.span("embed_forward"):
            x = images_u8.to(torch.float32) * self.spec.rescale
            x = ((x - mean) / std).to(self._dtype)
            out = self.replicas[replica](x)
            return out.to(torch.bfloat16 if self._fetch_bf16 else torch.float32)

    def _forward_async(self, images_u8: np.ndarray) -> list[torch.Tensor]:
        """Upload one padded batch and enqueue its forward, each data row's
        contiguous rows on its replica; returns the device tensors in row
        order (not fetched)."""
        from atlaspatch_tpu_torch.parallel.mesh import shard_batch

        devices = self._row_devices()
        outs = []
        with perf.stage("embed_dispatch"):
            host = torch.from_numpy(images_u8)
            if self.device.type == "cuda":
                host = host.pin_memory()
            parts = shard_batch(self.mesh, host) if self.mesh is not None else [host.to(self.device, non_blocking=True)]
            for i, rows in enumerate(parts):
                try:
                    outs.append(self.forward_device(rows, i))
                except Exception as e:
                    if self.mesh is None:
                        raise
                    raise RuntimeError(f"{self.name}: embedding replica {i} on {devices[i]} failed: {e}") from e
        return outs

    def _start_fetch(self, dev_outs: list[torch.Tensor]) -> list:
        """Start each device→host copy into a pinned buffer; returns what
        ``_materialize_f32`` completes."""
        if self.device.type != "cuda":
            return [(t, None) for t in dev_outs]
        fetches = []
        for dev_out in dev_outs:
            host = torch.empty(dev_out.shape, dtype=dev_out.dtype, pin_memory=True)
            host.copy_(dev_out, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev_out.device))
            fetches.append((host, event))
        return fetches

    @staticmethod
    def _materialize_f32(fetches: list) -> np.ndarray:
        """Wait for started fetches; float32 rows on the host, in order."""
        rows = []
        for host, event in fetches:
            if event is not None:
                event.synchronize()
            rows.append(host.float().numpy() if host.dtype != torch.float32 else host.numpy())
        return rows[0] if len(rows) == 1 else np.concatenate(rows, axis=0)

    # --- host pipeline -------------------------------------------------------------
    def extract_batch(
        self, patches: Sequence[np.ndarray], *, batch_size: int | None = None
    ) -> np.ndarray:
        if not len(patches):
            return np.empty((0, self.embedding_dim), dtype=np.float32)
        bs = min(self.max_batch, batch_size or len(patches))

        # Software pipeline: (a) per-chunk host preprocessing parallelized over
        # the thread pool, (b) forwards dispatched from `depth` threads, (c)
        # each chunk's device→host copy started as soon as its dispatch
        # returns, and waited for at the end (or when the window fills).
        def prep_chunk(ex: ThreadPoolExecutor, chunk) -> np.ndarray:
            if len(chunk) >= 4 and self.prep_workers > 1:
                slices = np.array_split(np.arange(len(chunk)), self.prep_workers)
                parts = ex.map(
                    lambda idx: [self.spec.apply_host(chunk[i]) for i in idx],
                    [s for s in slices if len(s)],
                )
                flat = [img for part in parts for img in part]
            else:
                flat = [self.spec.apply_host(p) for p in chunk]
            return np.stack(flat)

        chunks = [patches[i : i + bs] for i in range(0, len(patches), bs)]
        outputs: list[np.ndarray] = []
        depth = max(1, int(os.environ.get("ATLASPATCH_H2D_DEPTH", "2")))
        deferred = os.environ.get("ATLASPATCH_DEFERRED_FETCH", "1") == "1"
        # the window bounds the device memory of enqueued, unfetched chunks
        max_deferred = max(1, int(os.environ.get("ATLASPATCH_DEFERRED_MAX_CHUNKS", "64")))

        pending: deque[tuple] = deque()  # (dispatch future, n_valid)
        done: deque[tuple] = deque()  # (started fetch, n_valid)

        def _drain_one() -> None:
            fut, k = pending.popleft()
            if deferred:
                with perf.stage("embed_d2h_start"):
                    done.append((self._start_fetch(fut.result()), k))
                if len(done) > max_deferred:
                    fetch, k0 = done.popleft()
                    with perf.stage("embed_fetch"):
                        outputs.append(self._materialize_f32(fetch)[:k0])
            else:
                with perf.stage("embed_fetch"):
                    outputs.append(self._materialize_f32([(t.cpu(), None) for t in fut.result()])[:k])

        with ThreadPoolExecutor(max_workers=self.prep_workers) as ex, ThreadPoolExecutor(
            max_workers=depth, thread_name_prefix="h2d-dispatch"
        ) as dispatcher:
            for chunk in chunks:
                with perf.stage("embed_prep"):
                    imgs = prep_chunk(ex, chunk)
                n = imgs.shape[0]
                padded = _bucket(n, bs)
                padded += (-padded) % self._batch_align
                if padded != n:
                    imgs = np.concatenate(
                        [imgs, np.zeros((padded - n, *imgs.shape[1:]), imgs.dtype)]
                    )
                # drain BEFORE submitting so at most `depth` dispatches are outstanding
                while len(pending) >= depth:
                    _drain_one()
                pending.append((dispatcher.submit(self._forward_async, imgs), n))
            while pending:
                _drain_one()
            for fetch, k in done:
                with perf.stage("embed_fetch"):
                    outputs.append(self._materialize_f32(fetch)[:k])
        return np.concatenate(outputs, axis=0)

    def cleanup(self) -> None:
        self.model = self.replicas = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
