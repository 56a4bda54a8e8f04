"""End-to-end SAM2 image segmentation model (PyTorch) and its device steps.

Pipeline per batch: uint8 NHWC thumbnails → on-device bilinear upscale and
normalize → Hiera trunk → FPN neck → prompt-encode full-frame boxes →
two-way mask decoder → bilinear upscale to image_size → threshold →
PIL-NEAREST gather to the thumbnail shape → MSB-first bit-pack. The step
functions are plain functions of (model, tensors) run eagerly under
``torch.inference_mode``; they mirror the JAX package's jitted steps one for
one (reference behavior: atlas_patch/services/segmentation.py:104-140).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
from atlaspatch_tpu_torch.models.sam2.decoder import (
    MaskDecoder,
    PromptEncoder,
    RandomPositionalEmbedding,
)
from atlaspatch_tpu_torch.models.sam2.hiera import FpnNeck, HieraDet
from atlaspatch_tpu_torch.models.sam2.interp import interpolate_torch
from atlaspatch_tpu_torch.utils import perf


class VisionEncoder(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.backbone = HieraDet(cfg)
        self.neck = FpnNeck(cfg)


class SAM2ImageModel(nn.Module):
    """SAM2 trunk + neck + SAM heads for single-image mask prediction.

    Parameter names follow the transformers ``Sam2Model`` layout, so its
    state dicts load with ``strict=True``."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        self.shared_image_embedding = RandomPositionalEmbedding(cfg.prompt_hidden_size)
        self.vision_encoder = VisionEncoder(cfg)
        self.prompt_encoder = PromptEncoder(cfg, self.shared_image_embedding)
        self.mask_decoder = MaskDecoder(cfg)
        self.no_memory_embedding = nn.Parameter(torch.zeros(1, 1, cfg.fpn_hidden_size))

    def image_features(self, pixel_values: torch.Tensor):
        """NHWC normalized pixels → (feat_s0, feat_s1, image_embed) NHWC."""
        stage_outputs = self.vision_encoder.backbone(pixel_values)
        fpn = self.vision_encoder.neck(stage_outputs)  # low→high resolution
        levels = fpn[-self.cfg.num_feature_levels :][::-1]  # high→low: stride 4, 8, 16

        def conv_nhwc(conv, x):
            return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

        feat_s0 = conv_nhwc(self.mask_decoder.conv_s0, levels[0])
        feat_s1 = conv_nhwc(self.mask_decoder.conv_s1, levels[1])
        image_embed = levels[2] + self.no_memory_embedding[0][None]
        return feat_s0, feat_s1, image_embed

    def forward(self, pixel_values: torch.Tensor, boxes: torch.Tensor, multimask_output: bool = False):
        """pixel_values (B,H,W,3) normalized; boxes (B,P,4) xyxy pixels.

        Returns (low_res_masks (B,P,M,S4,S4), iou (B,P,M), obj logits (B,P,1)).
        """
        feat_s0, feat_s1, image_embed = self.image_features(pixel_values)
        sparse, dense = self.prompt_encoder(boxes)
        image_pe = self.prompt_encoder.image_wide_pe()
        return self.mask_decoder(
            image_embed,
            image_pe,
            sparse,
            dense,
            (feat_s0, feat_s1),
            multimask_output=multimask_output,
        )


def _param_dtype(model: nn.Module) -> torch.dtype:
    return next(model.parameters()).dtype


def normalize_images(cfg: SAM2Config, images: torch.Tensor) -> torch.Tensor:
    """uint8 (or float32 0..255) NHWC pixels → float32 normalized pixels."""
    mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=images.device)
    return (images.float() / 255.0 - mean) / std


def _full_frame_logits(model: SAM2ImageModel, pixels: torch.Tensor) -> torch.Tensor:
    """Normalized (B,S,S,3) pixels → (B,S,S) float32 logits for a full-frame
    box prompt and single-mask output, upscaled with torch-parity bilinear.
    Each call is one ``sam2_forward`` span (``perf.stage``), so an
    ``ATLASPATCH_TORCH_TRACE`` trace counts its forwards."""
    S = model.cfg.image_size
    B = pixels.shape[0]
    with perf.stage("sam2_forward"):
        box = torch.tensor([[0.0, 0.0, S, S]], dtype=torch.float32, device=pixels.device)
        boxes = box[None].expand(B, 1, 4)
        masks, _iou, _obj = model(pixels.to(_param_dtype(model)), boxes, multimask_output=False)
        low_res = masks[:, 0, 0].float()  # (B, S4, S4)
        return interpolate_torch(low_res[..., None], (S, S), "bilinear")[..., 0]


@torch.inference_mode()
def segment_step(model: SAM2ImageModel, images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B,S,S,3) → mask logits (B,S,S) float32."""
    return _full_frame_logits(model, normalize_images(model.cfg, images_u8))


@torch.inference_mode()
def thumbs_to_logits(model: SAM2ImageModel, thumbs_u8: torch.Tensor) -> torch.Tensor:
    """Native-size uint8 (B,h,w,3) thumbnails → (B,S,S) float32 logits. The
    upscale to the model input runs on device in float32 (same half-pixel
    mapping as the host PIL path, minus PIL's uint8 intermediate rounding)."""
    S = model.cfg.image_size
    up = interpolate_torch(thumbs_u8.float(), (S, S), "bilinear")
    return _full_frame_logits(model, normalize_images(model.cfg, up))


def _thumbs_to_mask_bits(model: SAM2ImageModel, thumbs_u8: torch.Tensor, threshold: float):
    """(B, S, S) uint8 binary mask, threshold applied to the upscaled logits."""
    return (thumbs_to_logits(model, thumbs_u8) > threshold).to(torch.uint8)


def _packbits_last_axis(bits: torch.Tensor) -> torch.Tensor:
    """(…, W) uint8 {0,1} → (…, W//8) uint8, numpy packbits MSB-first. W must
    already be a multiple of 8."""
    *lead, W = bits.shape
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=bits.device)
    packed = (bits.reshape(*lead, W // 8, 8).to(torch.int32) * weights).sum(dim=-1)
    return packed.to(torch.uint8)


@torch.inference_mode()
def segment_step_packed_from_thumbs(
    model: SAM2ImageModel, thumbs_u8: torch.Tensor, threshold: float
) -> torch.Tensor:
    """segment_step_packed with ON-DEVICE thumbnail upscaling.

    thumbs_u8: (B, h, w, 3) uint8 at the thumbnail's native size — shipping
    these instead of host-resized S² images shrinks the host→device transfer.
    """
    return _packbits_last_axis(_thumbs_to_mask_bits(model, thumbs_u8, threshold))


def pil_nearest_index(n_out: int, n_in: int) -> np.ndarray:
    """Source-index table of PIL's NEAREST resize, bit-exact.

    PIL (Geometry.c ImagingScaleAffine) walks the source coordinate
    incrementally — ``xo = scale*0.5; xo += scale`` per output pixel — so the
    accumulated float64 rounding decides near-tie pixels. Reproduced here the
    same way; a host table, uploaded once per shape by the predictor.
    """
    a0 = n_in / n_out
    xo = a0 * 0.5
    idx = np.empty(n_out, np.int64)
    for x in range(n_out):
        idx[x] = min(int(xo), n_in - 1)
        xo += a0
    return idx


@torch.inference_mode()
def segment_step_packed_to_shape(
    model: SAM2ImageModel,
    thumbs_u8: torch.Tensor,
    threshold: float,
    row_idx: torch.Tensor,
    col_idx: torch.Tensor,
) -> torch.Tensor:
    """segment_step_packed_from_thumbs + ON-DEVICE mask downsample.

    The pipeline only consumes the mask at the thumbnail's own resolution
    (the reference resizes the S² mask back with PIL NEAREST,
    segmentation.py:112-118), so the NEAREST resample runs on device with the
    exact PIL index tables (``pil_nearest_index``) and only the packed
    thumbnail-sized bits cross to the host.

    Returns (B, h, ceil(w/8)) uint8, packbits convention; callers slice the
    unpacked width back to w.
    """
    bits = _thumbs_to_mask_bits(model, thumbs_u8, threshold)
    small = bits.index_select(1, row_idx).index_select(2, col_idx)  # PIL-NEAREST gather
    w = col_idx.shape[0]
    w_pad = -(-w // 8) * 8
    if w_pad != w:
        small = F.pad(small, (0, w_pad - w))
    return _packbits_last_axis(small)


@torch.inference_mode()
def segment_step_packed(model: SAM2ImageModel, images_u8: torch.Tensor, threshold: float):
    """segment_step + on-device thresholding and bit-packing.

    Returns (B, S, S//8) uint8 — the binary mask packed MSB-first along the
    last axis (numpy packbits convention), 32× fewer bytes to the host than
    float32 logits; bit-identical to thresholding the logits on host.
    """
    bits = (segment_step(model, images_u8) > threshold).to(torch.uint8)
    return _packbits_last_axis(bits)


class SegmentReplicas:
    """Data-parallel serving: one replica of the SAM2 model per data device
    of ``mesh`` (the port of ``make_sharded_segment_step``'s replicated
    params). ``model`` itself is the first replica when it lies on the first
    data device; a device named twice gets two replicas.

    The forward is embarrassingly parallel over the batch, so no collective
    runs: ``run`` hands each replica its contiguous rows of the batch (whose
    leading dim the data size must divide; callers pad, see SAM2Predictor)
    and concatenates the outputs in order on the first data device. Replicas
    are dispatched one after another from the calling thread
    (``_run_replica`` is the per-device unit). A replica that fails fails the
    call, naming its device."""

    def __init__(self, model: SAM2ImageModel, mesh):
        from atlaspatch_tpu_torch.parallel.mesh import replicate

        self.mesh = mesh
        self.devices = mesh.data_devices
        self.replicas = replicate(mesh, model)

    def _run_replica(self, step, i: int, rows: torch.Tensor, threshold: float, idx: tuple) -> torch.Tensor:
        device = self.devices[i]
        try:
            with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
                return step(self.replicas[i], rows, threshold, *(t.to(device) for t in idx))
        except Exception as e:
            raise RuntimeError(f"segmentation replica {i} on {device} failed: {e}") from e

    def run(self, step, batch: torch.Tensor, threshold: float, *idx: torch.Tensor) -> torch.Tensor:
        """``step`` (one of the packed single-device steps) over the batch,
        split contiguously over the replicas."""
        from atlaspatch_tpu_torch.parallel.mesh import gather_rows, shard_batch

        parts = shard_batch(self.mesh, batch)
        outs = [self._run_replica(step, i, rows, threshold, idx) for i, rows in enumerate(parts)]
        return gather_rows(outs, self.devices[0])


def make_sharded_segment_step(model: SAM2ImageModel, mesh, *, from_thumbs: bool = True, to_shape: bool = False):
    """Multi-device serving step over ``mesh``'s data axis: ``step(batch,
    threshold[, row_idx, col_idx])`` takes the single-device step's
    arguments and gives its output (``to_shape``: the
    segment_step_packed_to_shape variant and its index tables)."""
    if to_shape:
        step = segment_step_packed_to_shape
    else:
        step = segment_step_packed_from_thumbs if from_thumbs else segment_step_packed
    return functools.partial(SegmentReplicas(model, mesh).run, step)

def init_params(cfg: SAM2Config, seed: int = 0) -> SAM2ImageModel:
    """A float32 CPU model with random weights drawn from a seeded
    ``torch.Generator``: Linear/Conv kernels N(0, 1/fan_in) with zero bias,
    token embeddings N(0, 0.02), the Fourier projection N(0, 1), LayerNorms
    at identity, positional embeddings zero (Flax's initializers, not its
    bits)."""
    model = SAM2ImageModel(cfg)
    gen = torch.Generator().manual_seed(seed)

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=gen) * std)

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.ConvTranspose2d):
                w = module.weight  # (I, O, kh, kw)
                normal_(w, (w.shape[0] * w.shape[2] * w.shape[3]) ** -0.5)
                module.bias.zero_()
            elif isinstance(module, (nn.Linear, nn.Conv2d)):
                normal_(module.weight, module.weight[0].numel() ** -0.5)
                module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                normal_(module.weight, 0.02)
            elif isinstance(module, nn.LayerNorm):
                module.reset_parameters()
            elif isinstance(module, RandomPositionalEmbedding):
                normal_(module.positional_embedding, 1.0)
    return model.eval()
