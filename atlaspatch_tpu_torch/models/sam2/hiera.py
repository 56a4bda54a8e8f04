"""Hiera (hierarchical ViT) trunk and FPN neck for SAM2, in PyTorch.

Architecture per the reference spec (reference: atlas_patch/configs/
sam2.1_hiera_t.yaml:9-15): conv patch embed stride 4, interpolated background
positional embedding + tiled window embedding, 4 stages with dim/head doubling,
query pooling (2x2 max) at the first block of stages 2-4, window attention with
per-stage window sizes, and full global attention at designated blocks.

Activations are NHWC between blocks, as in the JAX package; convolutions run
NCHW. Parameter names follow the transformers ``Sam2Model`` layout
(``vision_encoder.backbone.*`` / ``vision_encoder.neck.*``). Every trunk
attention goes through ``ops.attention.attention``: the hand-written CUDA
kernel on the card, the plain version on the CPU.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from atlaspatch_tpu_torch.models.sam2.config import HieraBlockSpec, SAM2Config
from atlaspatch_tpu_torch.models.sam2.interp import interpolate_torch
from atlaspatch_tpu_torch.ops.attention import attention


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Trunk GELU: exact erf by default (parity with the torch oracle);
    ATLASPATCH_GELU_TANH=1 opts into the tanh approximation. Read per call."""
    approx = "tanh" if os.environ.get("ATLASPATCH_GELU_TANH") == "1" else "none"
    return F.gelu(x, approximate=approx)


def window_partition(x: torch.Tensor, window_size: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """(B,H,W,C) → (B*nW, ws, ws, C) with bottom/right zero padding."""
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(
    windows: torch.Tensor, window_size: int, pad_hw: tuple[int, int], hw: tuple[int, int]
) -> torch.Tensor:
    """Inverse of window_partition, cropping away padding."""
    Hp, Wp = pad_hw
    H, W = hw
    C = windows.shape[-1]
    B = windows.shape[0] // ((Hp // window_size) * (Wp // window_size))
    x = windows.reshape(B, Hp // window_size, Wp // window_size, window_size, window_size, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W, :]


def max_pool_2x2(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(B,H,W,C) max pool, kernel=stride (floor mode, torch ceil_mode=False)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=stride, stride=stride)
    return y.permute(0, 2, 3, 1)


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int, query_stride: int | None = None):
        super().__init__()
        self.dim_out = dim_out
        self.num_heads = num_heads
        self.query_stride = query_stride  # 2 at stage transitions, else None
        self.qkv = nn.Linear(dim, dim_out * 3)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        head_dim = self.dim_out // self.num_heads
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads, head_dim)
        q, k, v = qkv.unbind(2)

        if self.query_stride:
            q = max_pool_2x2(q.reshape(B, H, W, self.dim_out), self.query_stride)
            H, W = q.shape[1], q.shape[2]
            q = q.reshape(B, H * W, self.num_heads, head_dim)

        out = attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), sm_scale=head_dim**-0.5
        )
        out = out.transpose(1, 2).reshape(B, H, W, self.dim_out)
        return self.proj(out)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.proj_in = nn.Linear(dim, hidden_dim)
        self.proj_out = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj_out(_gelu(self.proj_in(x)))


class MultiScaleBlock(nn.Module):
    """One trunk block; its (dim, window, query-stride) schedule entry comes
    from SAM2Config.block_schedule(), shared with validate_input_size."""

    def __init__(self, cfg: SAM2Config, spec: HieraBlockSpec):
        super().__init__()
        self.cfg = cfg
        self.spec = spec
        dim, dim_out = spec.dim, spec.dim_out
        eps = cfg.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(dim, eps=eps)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)
        self.attn = MultiScaleAttention(dim, dim_out, spec.num_heads, spec.query_stride)
        self.layer_norm2 = nn.LayerNorm(dim_out, eps=eps)
        self.mlp = MLP(dim_out, int(dim_out * cfg.mlp_ratio), dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        window_size = self.spec.window_size
        query_stride = self.spec.query_stride

        residual = x
        h = self.layer_norm1(x)

        if self.spec.dim != self.spec.dim_out:
            proj = self.proj(h)
            residual = max_pool_2x2(proj, query_stride) if query_stride else proj

        ws = window_size
        if window_size > 0:
            H, W = h.shape[1], h.shape[2]
            h, pad_hw = window_partition(h, window_size)

        h = self.attn(h)

        if query_stride:
            # un-partition on the POOLED grid (validate_input_size guards
            # that the window counts agree)
            ws = window_size // self.cfg.query_stride
            H, W = residual.shape[1], residual.shape[2]
            pad_h = (ws - H % ws) % ws if ws else 0
            pad_w = (ws - W % ws) % ws if ws else 0
            pad_hw = (H + pad_h, W + pad_w)

        if window_size > 0:
            h = window_unpartition(h, ws, pad_hw, (H, W))

        x = residual + h
        return x + self.mlp(self.layer_norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.projection = nn.Conv2d(
            3,
            cfg.hidden_size,
            kernel_size=cfg.patch_kernel,
            stride=cfg.patch_stride,
            padding=cfg.patch_padding,
        )

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """NHWC pixels → NHWC patch embeddings."""
        return self.projection(pixel_values.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class HieraDet(nn.Module):
    """Hiera trunk: returns per-stage feature maps (high → low resolution)."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        win0 = cfg.window_size_per_stage[0]
        self.patch_embed = PatchEmbed(cfg)
        # torch layout (1, C, h, w), as in the checkpoints
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.hidden_size, *cfg.window_pos_embed_bkg_size)
        )
        self.pos_embed_window = nn.Parameter(torch.zeros(1, cfg.hidden_size, win0, win0))
        self.blocks = nn.ModuleList(MultiScaleBlock(cfg, spec) for spec in cfg.block_schedule())

    def forward(self, pixel_values: torch.Tensor) -> list[torch.Tensor]:
        cfg = self.cfg
        x = self.patch_embed(pixel_values)
        h, w = x.shape[1], x.shape[2]
        win0 = cfg.window_size_per_stage[0]
        # Interpolate the background embedding to (h, w) with torch-exact
        # bicubic (a=-0.75, align_corners=False) and tile the window embedding.
        pos = interpolate_torch(self.pos_embed.permute(0, 2, 3, 1), (h, w), "bicubic").to(x.dtype)
        pos = pos + self.pos_embed_window.permute(0, 2, 3, 1).tile(1, h // win0, w // win0, 1)
        x = x + pos

        outputs: list[torch.Tensor] = []
        stage_ends = set(cfg.stage_ends)
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in stage_ends:
                outputs.append(x)
        return outputs


def trunk_attention_shapes(
    cfg: SAM2Config, size: int, batch: int
) -> list[tuple[int, int, int, int, int]]:
    """(batch·windows, heads, T_q, T_kv, head_dim) of each trunk block's
    attention call at input ``size``, in block order: what the kernel is
    handed on the main path (for timing it at those shapes)."""
    grid = size // cfg.patch_stride
    shapes = []
    for spec in cfg.block_schedule():
        win, qs = spec.window_size, spec.query_stride
        span = win if win else grid
        n = batch * (-(-grid // win)) ** 2 if win else batch
        t_kv = span * span
        t_q = (span // qs) ** 2 if qs else t_kv
        shapes.append((n, spec.num_heads, t_q, t_kv, spec.dim_out // spec.num_heads))
        if qs:
            grid //= qs
    return shapes


class FpnNeck(nn.Module):
    """FPN neck: lateral 1x1 convs to fpn_hidden_size + nearest top-down fusion
    for the configured levels (reference spec: fpn_top_down_levels [2,3])."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        self.convs = nn.ModuleList(
            nn.Conv2d(c, cfg.fpn_hidden_size, kernel_size=1) for c in cfg.backbone_channel_list
        )

    def forward(self, stage_outputs: list[torch.Tensor]) -> list[torch.Tensor]:
        """NHWC stage outputs → NHWC levels, low → high resolution (HF order)."""
        n = len(self.cfg.backbone_channel_list) - 1
        outputs: list[torch.Tensor] = []
        prev = None
        # stage_outputs[i] has channels embed_dim_per_stage[i]; convs are ordered
        # by backbone_channel_list (low-res first), so conv index is n - i.
        for i in range(n, -1, -1):
            lateral = self.convs[n - i](stage_outputs[i].permute(0, 3, 1, 2))
            if i in self.cfg.fpn_top_down_levels and i != n and prev is not None:
                top_down = prev.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                prev = lateral + top_down
            else:
                prev = lateral
            outputs.append(prev.permute(0, 2, 3, 1))
        return outputs
