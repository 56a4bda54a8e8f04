"""SAM2 tissue-segmentation service on PyTorch/CUDA.

Pipeline parity with the reference (reference: atlas_patch/services/
segmentation.py:25-237): thumbnails at power 1.25 capped at 1024px, bilinear
resize to the model input, full-frame box prompt, single-mask output, mask
resized back to the thumbnail shape with PIL NEAREST.

Device path: native-size thumbnails are grouped by shape and each group runs
one device step (``segment_step_packed_to_shape``): on-device upscale and
normalize → Hiera → FPN → decoder → upscale → threshold → PIL-NEAREST gather
→ bit-pack. Only the packed thumbnail-sized bits come back, through a pinned
host buffer and a CUDA event, so the caller can overlap the next batch.

Device: ``cfg.device`` ("cuda" by default). A CUDA request on a machine
without CUDA raises; there is no silent CPU fallback. With a ``mesh``
(``parallel/mesh.py``) every data device holds a replica and each batch,
padded to a multiple of the data size, is split over them
(``SegmentReplicas``); the masks are the one-device predictor's. Checkpoint: explicit
path, or ATLASPATCH_SAM2_CHECKPOINT, or a converted ``.npz`` in
ATLASPATCH_WEIGHTS_DIR, or the HF-cached reference checkpoint; otherwise
random init only with ATLASPATCH_ALLOW_RANDOM_WEIGHTS=1, else an error.

Pillow is imported only by the host-resize path and thumbnail preparation.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from atlaspatch_tpu_torch.core.config import SegmentationConfig
from atlaspatch_tpu_torch.core.models import Mask
from atlaspatch_tpu_torch.io.iwsi import IWSI
from atlaspatch_tpu_torch.models.sam2 import model as sam2_model
from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
from atlaspatch_tpu_torch.models.sam2.convert import load_checkpoint, load_into, load_npz
from atlaspatch_tpu_torch.services.interfaces import SegmentationService
from atlaspatch_tpu_torch.utils import perf

logger = logging.getLogger("atlaspatch_tpu_torch.segmentation_service")

_ENV_CHECKPOINT = "ATLASPATCH_SAM2_CHECKPOINT"


def _pad_to_pow2_batch(n: int, max_batch: int) -> int:
    """Pad batch to a power of two, capped at max_batch (callers guarantee
    max_batch >= n), so few batch shapes occur."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(max(b, n), max_batch)


class _PackedFetch:
    """A packed-bits result on its way to the host.

    On CUDA the copy goes into a pinned host buffer with ``non_blocking=True``
    and a CUDA event marks its end; ``numpy()`` waits on that event only."""

    def __init__(self, packed: torch.Tensor):
        if packed.device.type == "cuda":
            self._host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(packed.device))
        else:
            self._host = packed
            self._event = None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class SAM2Predictor:
    """Batched SAM2 mask prediction with resizing helpers, on one device or
    data-parallel over the data axis of ``mesh``."""

    def __init__(
        self,
        cfg: SegmentationConfig,
        sam2_cfg: SAM2Config | None = None,
        *,
        mesh=None,
    ):
        self.cfg = cfg
        self._mesh = mesh
        self._n_data = mesh.shape["data"] if mesh is not None else 1
        # device-resident PIL-NEAREST index tables keyed (n_out, n_in): the
        # host loops + H2D upload run once per shape, not once per dispatch
        self._resample_idx: dict[tuple[int, int], torch.Tensor] = {}
        if sam2_cfg is not None:
            self.sam2_cfg = sam2_cfg
        elif cfg.config_path is not None:
            self.sam2_cfg = SAM2Config.from_reference_yaml(cfg.config_path)
        else:
            self.sam2_cfg = SAM2Config.tiny()
        override = cfg.input_size
        if override is not None and override != self.sam2_cfg.image_size:
            # Run the trunk at a different square resolution. Checkpoints are
            # size-agnostic (pos-embeds interpolate from the 7x7 background
            # grid per call), so the same weights load at any multiple of 32.
            # Loud guard: some (window spec, size) pairs cannot tile. A size
            # chosen by the --fast preset (not typed by the user) falls back
            # to the architecture's native size instead of failing.
            try:
                self.sam2_cfg.validate_input_size(int(override))
            except ValueError:
                if not cfg.input_size_preset:
                    raise
                logger.info(
                    "--fast preset input size %d does not tile this SAM2 "
                    "window spec; keeping the architecture's native %d.",
                    int(override), self.sam2_cfg.image_size,
                )
                override = None
            if override is not None:
                self.sam2_cfg = dataclasses.replace(self.sam2_cfg, image_size=int(override))
        self.input_size = self.sam2_cfg.image_size

        # with a mesh, the first data device holds the first replica
        self.device = mesh.data_devices[0] if mesh is not None else torch.device(cfg.device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"SAM2 predictor asked for device {str(self.device)!r}, but CUDA is not "
                    "available; pass device='cpu' to run on the CPU."
                )
            if cfg.precision == "float32":
                # The float32 mode is the reference-exact mode: keep matmuls
                # AND cuDNN convolutions in full float32 (cuDNN defaults to
                # TF32, which keeps ~3 decimal digits). Process-wide setting,
                # so every replica computes under it.
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
        logger.info("SAM2 predictor device: %s", mesh if mesh is not None else self.device)

        self.model = self._load_model()
        # every replica holds the model as loaded and cast (bf16 included)
        self._replicas = sam2_model.SegmentReplicas(self.model, mesh) if mesh is not None else None

    def _resolve_checkpoint_path(self) -> Path | None:
        if self.cfg.checkpoint_path is not None:
            return Path(self.cfg.checkpoint_path)
        env = os.environ.get(_ENV_CHECKPOINT)
        if env:
            return Path(env)
        wdir = os.environ.get("ATLASPATCH_WEIGHTS_DIR")
        if wdir:
            cand = Path(wdir) / "sam2_hiera_tiny.npz"  # the JAX package's converted archive
            if cand.exists():
                return cand
        # Look in the HF cache for the reference checkpoint without network.
        hf_home = Path(os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface"))
        for pattern in (
            "hub/models--AtlasAnalyticsLab--AtlasPatch/snapshots/*/model.pth",
            "hub/models--facebook--sam2.1-hiera-tiny/snapshots/*/*.pt",
        ):
            matches = sorted(hf_home.glob(pattern))
            if matches:
                # snapshot dirs are commit hashes — prefer the most recently
                # fetched revision
                return max(matches, key=lambda p: p.stat().st_mtime)
        return None

    def _load_model(self) -> sam2_model.SAM2ImageModel:
        ckpt = self._resolve_checkpoint_path()
        if ckpt is not None and ckpt.exists():
            logger.info("Loading SAM2 checkpoint from %s", ckpt)
            model = sam2_model.SAM2ImageModel(self.sam2_cfg)
            if ckpt.suffix == ".npz":
                sd = load_npz(ckpt, self.sam2_cfg)
            else:
                sd = load_checkpoint(str(ckpt))
            load_into(model, sd)
        elif os.environ.get("ATLASPATCH_ALLOW_RANDOM_WEIGHTS") == "1":
            logger.warning(
                "No SAM2 checkpoint found (set %s or --checkpoint); using random init "
                "because ATLASPATCH_ALLOW_RANDOM_WEIGHTS=1. Masks will not be meaningful.",
                _ENV_CHECKPOINT,
            )
            model = sam2_model.init_params(self.sam2_cfg)
        else:
            # Same load-or-raise contract as the reference
            # (atlas_patch/services/segmentation.py:46-68).
            raise RuntimeError(
                f"No SAM2 checkpoint found (set {_ENV_CHECKPOINT} or --checkpoint, "
                "or place the finetuned model.pth in the HF cache). Set "
                "ATLASPATCH_ALLOW_RANDOM_WEIGHTS=1 to run with random weights "
                "for benchmarking only."
            )
        # bfloat16 mode casts EVERY parameter and buffer, so no float32
        # parameter silently upcasts a matmul.
        dtype = torch.bfloat16 if self.cfg.precision == "bfloat16" else torch.float32
        return model.to(device=self.device, dtype=dtype).eval()

    # --- input/output resizing (host, PIL semantics as in the reference) -----------
    def _normalize_input(self, image) -> np.ndarray:
        if not isinstance(image, np.ndarray) and hasattr(image, "convert"):  # PIL image
            if image.mode != "RGB":
                image = image.convert("RGB")
            return np.array(image, copy=True)
        arr = np.asarray(image)
        if arr.dtype in (np.float32, np.float64) and arr.max() <= 1.0:
            arr = (arr * 255).astype(np.uint8)
        elif arr.dtype != np.uint8:
            arr = arr.astype(np.uint8)
        if arr.ndim == 3 and arr.shape[0] == 3 and arr.shape[-1] != 3:
            arr = np.transpose(arr, (1, 2, 0))
        return np.ascontiguousarray(arr)

    def _resize_input(self, image: np.ndarray) -> tuple[np.ndarray, tuple[int, int]]:
        orig = (int(image.shape[0]), int(image.shape[1]))
        if orig == (self.input_size, self.input_size):
            return image, orig
        from PIL import Image

        pil = Image.fromarray(image)
        resized = pil.resize((self.input_size, self.input_size), Image.Resampling.BILINEAR)
        return np.array(resized, copy=True), orig

    def _resize_mask(self, mask: np.ndarray, target_shape: tuple[int, int]) -> np.ndarray:
        from PIL import Image

        mask_u8 = (mask * 255).astype(np.uint8)
        pil = Image.fromarray(mask_u8, mode="L")
        resized = pil.resize((target_shape[1], target_shape[0]), resample=Image.Resampling.NEAREST)
        return np.asarray(resized, dtype=np.float32) / 255.0

    # --- prediction ----------------------------------------------------------------
    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(batch).to(self.device, non_blocking=True)

    def _step(self, step, batch: np.ndarray, threshold: float, *idx: torch.Tensor) -> torch.Tensor:
        """One packed step over a host batch: on the device, or split over the
        mesh's replicas (the host batch uploads per replica)."""
        if self._replicas is not None:
            return self._replicas.run(step, torch.from_numpy(batch), threshold, *idx)
        return step(self.model, self._to_device(batch), threshold, *idx)

    def _pad_to_data(self, batch: np.ndarray) -> np.ndarray:
        """Zero rows appended so the data size divides the batch."""
        pad = (-batch.shape[0]) % self._n_data
        if not pad:
            return batch
        return np.concatenate([batch, np.zeros((pad, *batch.shape[1:]), batch.dtype)])

    def predict_masks_async(self, images_u8: np.ndarray) -> _PackedFetch:
        """Dispatch the packed step on (B,S,S,3) uint8 model-input images;
        returns the in-flight fetch WITHOUT waiting for it."""
        with perf.stage("segment_dispatch"):
            n = images_u8.shape[0]
            packed = self._step(
                sam2_model.segment_step_packed, self._pad_to_data(images_u8), float(self.cfg.mask_threshold)
            )
            return _PackedFetch(packed[:n])

    def predict_masks_grouped_async(
        self,
        arrs: Sequence[np.ndarray],
        targets: Sequence[tuple[int, int]] | None = None,
    ):
        """Dispatch native-size thumbnails grouped by shape; the bilinear
        upscale to the model input runs ON DEVICE (host→device bytes shrink by
        the thumbnail/model-size ratio).

        With ``targets`` (per-item (h, w)), the mask's PIL-NEAREST resample to
        that shape ALSO runs on device, so only thumbnail-sized packed bits
        come back; masks return already at their target shapes. Without
        targets or with ATLASPATCH_DEVICE_MASK_RESIZE=0, returns
        model-input-sized masks.
        """
        device_resize = (
            targets is not None
            and os.environ.get("ATLASPATCH_DEVICE_MASK_RESIZE", "1") != "0"
        )

        groups: dict[tuple, list[int]] = {}
        for i, a in enumerate(arrs):
            key = (a.shape[0], a.shape[1], targets[i] if device_resize else None)
            groups.setdefault(key, []).append(i)

        threshold = float(self.cfg.mask_threshold)
        handles = []
        with perf.stage("segment_dispatch"):
            for (h, w, target), idxs in groups.items():
                padded = _pad_to_pow2_batch(len(idxs), max_batch=max(self.cfg.batch_size, len(idxs)))
                padded += (-padded) % self._n_data
                batch = np.zeros((padded, h, w, 3), dtype=np.uint8)
                for j, i in enumerate(idxs):
                    batch[j] = arrs[i]
                if target is not None:
                    idx = tuple(self._resample_index(n_out) for n_out in target)
                    packed = self._step(sam2_model.segment_step_packed_to_shape, batch, threshold, *idx)
                else:
                    packed = self._step(sam2_model.segment_step_packed_from_thumbs, batch, threshold)
                # The D2H copy is queued behind the step right away, so the
                # bits cross while the host prepares the next batch.
                handles.append((_PackedFetch(packed), idxs, target))

        def resolve() -> list[np.ndarray]:
            out: list[np.ndarray | None] = [None] * len(arrs)
            with perf.stage("segment_fetch"):
                for fetch, idxs, target in handles:
                    bits = np.unpackbits(fetch.numpy(), axis=-1)
                    if target is not None:
                        bits = bits[:, :, : target[1]]  # drop byte padding
                    for j, i in enumerate(idxs):
                        out[i] = bits[j]
            return out  # type: ignore[return-value]

        return resolve

    def _resample_index(self, n_out: int) -> torch.Tensor:
        key = (n_out, self.input_size)
        cached = self._resample_idx.get(key)
        if cached is None:
            idx = sam2_model.pil_nearest_index(n_out, self.input_size)
            cached = torch.from_numpy(idx).to(self.device)
            self._resample_idx[key] = cached
        return cached

    @staticmethod
    def fetch_masks(fetch: _PackedFetch) -> np.ndarray:
        with perf.stage("segment_fetch"):
            packed_np = fetch.numpy()
        return np.unpackbits(packed_np, axis=-1)

    def predict_masks(self, images_u8: np.ndarray) -> np.ndarray:
        """(B,S,S,3) uint8 → (B,S,S) uint8 binary masks (threshold on device,
        only packed bits cross to the host)."""
        with perf.stage("segment_device"):
            return self.fetch_masks(self.predict_masks_async(images_u8))

    def predict_batch(self, images: Sequence, *, resize_to_input: bool = True) -> list[np.ndarray]:
        if not len(images):
            raise ValueError("images must be a non-empty sequence")
        arrs, orig_shapes = [], []
        for img in images:
            resized, orig = self._resize_input(self._normalize_input(img))
            arrs.append(resized)
            orig_shapes.append(orig)

        n = len(arrs)
        padded = _pad_to_pow2_batch(n, max_batch=max(self.cfg.batch_size, n))
        batch = np.zeros((padded, self.input_size, self.input_size, 3), dtype=np.uint8)
        batch[:n] = np.stack(arrs)
        bin_masks = self.predict_masks(batch)[:n]

        out: list[np.ndarray] = []
        for i in range(n):
            mask = bin_masks[i].astype(np.float32)
            if resize_to_input and mask.shape[:2] != orig_shapes[i]:
                mask = self._resize_mask(mask, orig_shapes[i])
            out.append(mask.astype(np.float32))
        return out

    def predict_image(self, image, *, resize_to_input: bool = True) -> np.ndarray:
        return self.predict_batch([image], resize_to_input=resize_to_input)[0]

    def close(self) -> None:
        self.model = self._replicas = None


class SAM2SegmentationService(SegmentationService):
    """Segmentation service that wraps the SAM2 predictor and standardizes masks."""

    def __init__(
        self,
        cfg: SegmentationConfig | None = None,
        sam2_cfg: SAM2Config | None = None,
        *,
        device: str | None = None,
        mesh=None,
    ) -> None:
        cfg = cfg if cfg is not None else SegmentationConfig()
        if device is not None:
            cfg = dataclasses.replace(cfg, device=device)
        self.cfg = cfg.validated()
        self.predictor = SAM2Predictor(self.cfg, sam2_cfg, mesh=mesh)
        self._thumb_pool_obj: ThreadPoolExecutor | None = None

    def _thumb_quant(self) -> int:
        """Shape-bucket quantum for thumbnails in the fast (non-float32,
        device-resize) mode: snapping dims to multiples of 32
        (ATLASPATCH_THUMB_QUANT, 0 disables) collapses a mixed corpus into a
        few batch shapes at ≤ ~3% scale perturbation; the reference-exact
        float32 / host-resize chains are never quantized."""
        if self.cfg.precision == "float32":
            return 0
        if os.environ.get("ATLASPATCH_HOST_RESIZE") == "1":
            return 0
        try:
            return max(0, int(os.environ.get("ATLASPATCH_THUMB_QUANT", "32")))
        except ValueError:
            return 0

    def _prepare_thumbnail(self, wsi: IWSI):
        with perf.stage("thumbnail"):
            # bfloat16 runs already depart from the reference's exact numeric
            # chain, so JPEG pyramids may decode thumbnails at 1/2–1/8 scale;
            # float32 keeps the reference-exact full-decode + AREA chain.
            q = self._thumb_quant()
            thumb = wsi.get_thumbnail_at_power(
                power=self.cfg.thumbnail_power,
                interpolation="optimise",
                scaled_decode=self.cfg.precision != "float32",
                quantize=q,
                max_px=self.cfg.thumbnail_max if q else 0,
            )
            if not q and self.cfg.thumbnail_max:
                thumb.thumbnail((self.cfg.thumbnail_max, self.cfg.thumbnail_max))
            return thumb

    def segment_thumbnail(self, wsi: IWSI) -> Mask:
        thumb = self._prepare_thumbnail(wsi)
        mask_arr = self.predictor.predict_image(thumb, resize_to_input=True)
        return Mask(
            data=mask_arr.astype(np.float32),
            source_shape=(int(mask_arr.shape[0]), int(mask_arr.shape[1])),
        )

    def prepare_thumbnails(self, wsis: Sequence[IWSI]) -> list:
        """Host stage: thumbnails on a thread pool, so a caller can overlap it
        with the device stage of the previous batch."""
        return list(self._thumb_pool().map(self._prepare_thumbnail, wsis))

    def _thumb_pool(self) -> ThreadPoolExecutor:
        if self._thumb_pool_obj is None:
            self._thumb_pool_obj = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 8), thread_name_prefix="thumb"
            )
        return self._thumb_pool_obj

    def prepare_thumbnails_safe(self, wsis: Sequence[IWSI]) -> list:
        """prepare_thumbnails with per-slide fault isolation: each element is
        the thumbnail OR the exception that slide raised (bad metadata,
        truncated pyramid, ...), so one poisoned slide cannot sink its whole
        batch. (The reference fails the full batch here: reference
        cli.py:384-391.)"""

        def one(w: IWSI):
            try:
                return self._prepare_thumbnail(w)
            except Exception as e:  # noqa: BLE001 — per-slide report
                return e

        return list(self._thumb_pool().map(one, wsis))

    def segment_thumbnails_async(self, thumbs: Sequence):
        """Dispatch the device stage; returns a zero-arg resolve() producing the
        masks, so a caller can overlap batch i+1's transfer+compute with batch
        i's readback.

        Default path ships native-size thumbnails and upscales on device
        (predict_masks_grouped_async); ATLASPATCH_HOST_RESIZE=1 selects the
        PIL host-resize path (bit-matches the reference's input chain).
        """
        if os.environ.get("ATLASPATCH_HOST_RESIZE") == "1":
            return self._segment_thumbnails_async_host_resize(thumbs)

        size = self.predictor.input_size
        arrs = [self.predictor._normalize_input(img) for img in thumbs]
        orig_shapes = [(a.shape[0], a.shape[1]) for a in arrs]
        # Device upscaling matches PIL only for UPSAMPLING; oversized thumbnails
        # are resized on host with PIL's antialiased filter first.
        arrs = [
            a if (a.shape[0] <= size and a.shape[1] <= size)
            else self.predictor._resize_input(a)[0]
            for a in arrs
        ]
        resolve_bits = self.predictor.predict_masks_grouped_async(arrs, targets=orig_shapes)

        def resolve() -> list[Mask]:
            out = []
            for bits, orig in zip(resolve_bits(), orig_shapes):
                mask = np.asarray(bits, dtype=np.float32)
                if mask.shape[:2] != orig:
                    # env-disabled device resize returns model-input-sized masks
                    mask = np.asarray(self.predictor._resize_mask(mask, orig), dtype=np.float32)
                out.append(Mask(data=mask, source_shape=(int(mask.shape[0]), int(mask.shape[1]))))
            return out

        return resolve

    def _segment_thumbnails_async_host_resize(self, thumbs: Sequence):
        arrs, orig_shapes = [], []
        for img in thumbs:
            resized, orig = self.predictor._resize_input(self.predictor._normalize_input(img))
            arrs.append(resized)
            orig_shapes.append(orig)
        n = len(arrs)
        size = self.predictor.input_size
        padded = _pad_to_pow2_batch(n, max_batch=max(self.cfg.batch_size, n))
        batch = np.zeros((padded, size, size, 3), dtype=np.uint8)
        batch[:n] = np.stack(arrs)
        fetch = self.predictor.predict_masks_async(batch)

        def resolve() -> list[Mask]:
            bin_masks = self.predictor.fetch_masks(fetch)[:n]
            out = []
            for i in range(n):
                mask = bin_masks[i].astype(np.float32)
                if mask.shape[:2] != orig_shapes[i]:
                    mask = self.predictor._resize_mask(mask, orig_shapes[i])
                out.append(
                    Mask(
                        data=mask.astype(np.float32),
                        source_shape=(int(mask.shape[0]), int(mask.shape[1])),
                    )
                )
            return out

        return resolve

    def segment_thumbnails(self, thumbs: Sequence) -> list[Mask]:
        """Device stage: one fused batch over prepared thumbnails."""
        return self.segment_thumbnails_async(thumbs)()

    def segment_batch(self, wsis: Sequence[IWSI]) -> list[Mask]:
        return self.segment_thumbnails(self.prepare_thumbnails(wsis))

    def close(self) -> None:
        if self._thumb_pool_obj is not None:
            self._thumb_pool_obj.shutdown(wait=False)
            self._thumb_pool_obj = None
        self.predictor.close()
