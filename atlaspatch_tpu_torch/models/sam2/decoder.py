"""SAM2 prompt encoder, two-way transformer, and mask decoder in PyTorch.

Image-prediction path only (the reference's usage: a full-frame box prompt per
thumbnail, multimask_output=False — reference: atlas_patch/services/
segmentation.py:128-136). Semantics mirror the JAX package's modules, NHWC
feature maps; parameter names follow the transformers ``Sam2Model`` layout.
Every LayerNorm here uses Flax's default eps=1e-6, as the JAX package does.
The decoder's attention is plain torch matmuls (the JAX package leaves it to
XLA outside any kernel).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from atlaspatch_tpu_torch.models.sam2.config import SAM2Config

_LN_EPS = 1e-6  # flax.linen.LayerNorm default


class FeedForward(nn.Module):
    """proj_in → act → hidden layers → proj_out (+ optional sigmoid)."""

    def __init__(
        self,
        input_dim: int,
        hidden_dim: int,
        output_dim: int,
        num_layers: int,
        sigmoid_output: bool = False,
    ):
        super().__init__()
        self.proj_in = nn.Linear(input_dim, hidden_dim)
        self.layers = nn.ModuleList(nn.Linear(hidden_dim, hidden_dim) for _ in range(num_layers - 2))
        self.proj_out = nn.Linear(hidden_dim, output_dim)
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.proj_in(x))
        for layer in self.layers:
            x = F.relu(layer(x))
        x = self.proj_out(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class RandomPositionalEmbedding(nn.Module):
    """Random-Fourier positional encoding for normalized [0,1] coordinates."""

    def __init__(self, hidden_size: int):
        super().__init__()
        # a buffer in the checkpoints: the Gaussian projection matrix
        self.register_buffer("positional_embedding", torch.zeros(2, hidden_size // 2))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:
        coords = 2.0 * coords01 - 1.0
        proj = (2.0 * math.pi) * (coords.to(self.positional_embedding.dtype) @ self.positional_embedding)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class MaskEmbedding(nn.Module):
    """Mask-prompt downscaler. The box-only path never runs it; its parameters
    exist so that checkpoints in the transformers layout load with strict=True."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        c = cfg.mask_input_channels
        self.conv1 = nn.Conv2d(1, c // 4, kernel_size=2, stride=2)
        self.conv2 = nn.Conv2d(c // 4, c, kernel_size=2, stride=2)
        self.conv3 = nn.Conv2d(c, cfg.prompt_hidden_size, kernel_size=1)
        self.layer_norm1 = nn.LayerNorm(c // 4, eps=_LN_EPS)
        self.layer_norm2 = nn.LayerNorm(c, eps=_LN_EPS)


class PromptEncoder(nn.Module):
    """Encodes box prompts into sparse tokens + dense embedding."""

    def __init__(self, cfg: SAM2Config, shared_embedding: RandomPositionalEmbedding):
        super().__init__()
        self.cfg = cfg
        hs = cfg.prompt_hidden_size
        self.shared_embedding = shared_embedding  # tied to SAM2ImageModel.shared_image_embedding
        self.mask_embed = MaskEmbedding(cfg)
        self.no_mask_embed = nn.Embedding(1, hs)
        self.point_embed = nn.Embedding(4, hs)
        self.not_a_point_embed = nn.Embedding(1, hs)

    @property
    def image_embedding_size(self) -> int:
        return self.cfg.image_size // 16

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """(B, P, 4) xyxy in image pixels → (B, P, 3, C) sparse tokens
        [top-left + PE2, bottom-right + PE3, not-a-point pad]."""
        coords = (boxes + 0.5).reshape(*boxes.shape[:2], 2, 2) / self.cfg.image_size
        corner_pe = self.shared_embedding(coords)
        point_embed = self.point_embed.weight
        tl = corner_pe[:, :, 0, :] + point_embed[2]
        br = corner_pe[:, :, 1, :] + point_embed[3]
        pad = self.not_a_point_embed.weight[0].expand_as(tl)
        return torch.stack([tl, br, pad], dim=2)

    def dense_no_mask(self, batch_size: int) -> torch.Tensor:
        s = self.image_embedding_size
        return self.no_mask_embed.weight[0].reshape(1, 1, 1, -1).expand(batch_size, s, s, -1)

    def image_wide_pe(self) -> torch.Tensor:
        """(1, S, S, C) dense positional encoding over the image embedding grid."""
        s = self.image_embedding_size
        device = self.no_mask_embed.weight.device
        grid = (torch.arange(s, dtype=torch.float32, device=device) + 0.5) / s
        gy, gx = torch.meshgrid(grid, grid, indexing="ij")
        coords = torch.stack([gx, gy], dim=-1)  # (S,S,[x,y])
        return self.shared_embedding(coords)[None]

    def forward(self, boxes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.embed_boxes(boxes), self.dense_no_mask(boxes.shape[0])


class DecoderAttention(nn.Module):
    """Attention with optional internal downsampling (SAM two-way transformer)."""

    def __init__(self, hidden_size: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        internal = hidden_size // downsample_rate
        self.num_heads = num_heads
        self.internal = internal
        self.q_proj = nn.Linear(hidden_size, internal)
        self.k_proj = nn.Linear(hidden_size, internal)
        self.v_proj = nn.Linear(hidden_size, internal)
        self.o_proj = nn.Linear(internal, hidden_size)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        head_dim = self.internal // self.num_heads
        B, P = q.shape[:2]

        def split(x):
            return x.reshape(B * P, -1, self.num_heads, head_dim).transpose(1, 2)

        qh, kh, vh = split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v))
        attn = torch.matmul(qh, kh.transpose(-1, -2)) * (head_dim**-0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(qh.dtype)
        out = torch.matmul(attn, vh)
        out = out.transpose(1, 2).reshape(B, P, -1, self.internal)
        return self.o_proj(out)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: SAM2Config, skip_first_layer_pe: bool = False):
        super().__init__()
        hs, heads, rate = cfg.prompt_hidden_size, cfg.decoder_num_heads, cfg.attention_downsample_rate
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(hs, heads, 1)
        self.layer_norm1 = nn.LayerNorm(hs, eps=_LN_EPS)
        self.cross_attn_token_to_image = DecoderAttention(hs, heads, rate)
        self.layer_norm2 = nn.LayerNorm(hs, eps=_LN_EPS)
        # the per-block MLP is structurally lin1/lin2 (2 Linear layers)
        # regardless of how many transformer layers the decoder stacks
        self.mlp = FeedForward(hs, cfg.decoder_mlp_dim, hs, num_layers=2)
        self.layer_norm3 = nn.LayerNorm(hs, eps=_LN_EPS)
        self.layer_norm4 = nn.LayerNorm(hs, eps=_LN_EPS)
        self.cross_attn_image_to_token = DecoderAttention(hs, heads, rate)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.layer_norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = self.layer_norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.layer_norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        keys = self.layer_norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        hs = cfg.prompt_hidden_size
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(cfg, skip_first_layer_pe=(i == 0))
            for i in range(cfg.decoder_num_layers)
        )
        self.final_attn_token_to_image = DecoderAttention(
            hs, cfg.decoder_num_heads, cfg.attention_downsample_rate
        )
        self.layer_norm_final_attn = nn.LayerNorm(hs, eps=_LN_EPS)

    def forward(self, point_embeddings, image_embeddings, image_pe):
        """point_embeddings (B,P,T,C); image_embeddings/image_pe (B,P,HW,C)."""
        queries, keys = point_embeddings, image_embeddings
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embeddings, image_pe)
        q = queries + point_embeddings
        k = keys + image_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.layer_norm_final_attn(queries), keys


def _conv_transpose_nhwc(conv: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        hs = cfg.prompt_hidden_size
        num_mask_tokens = cfg.num_multimask_outputs + 1
        self.num_mask_tokens = num_mask_tokens
        self.iou_token = nn.Embedding(1, hs)
        self.mask_tokens = nn.Embedding(num_mask_tokens, hs)
        self.obj_score_token = nn.Embedding(1, hs)
        self.transformer = TwoWayTransformer(cfg)
        self.upscale_conv1 = nn.ConvTranspose2d(hs, hs // 4, kernel_size=2, stride=2)
        self.upscale_conv2 = nn.ConvTranspose2d(hs // 4, hs // 8, kernel_size=2, stride=2)
        self.upscale_layer_norm = nn.LayerNorm(hs // 4, eps=_LN_EPS)
        self.output_hypernetworks_mlps = nn.ModuleList(
            FeedForward(hs, hs, hs // 8, 3) for _ in range(num_mask_tokens)
        )
        self.iou_prediction_head = FeedForward(
            hs, cfg.iou_head_hidden_dim, num_mask_tokens, cfg.iou_head_depth, sigmoid_output=True
        )
        # 1x1 projections of the two high-res levels; applied once per image by
        # SAM2ImageModel.image_features (they live here in the checkpoints)
        self.conv_s0 = nn.Conv2d(cfg.fpn_hidden_size, hs // 8, kernel_size=1)
        self.conv_s1 = nn.Conv2d(cfg.fpn_hidden_size, hs // 4, kernel_size=1)
        self.pred_obj_score_head = FeedForward(hs, hs, 1, 3)

    def forward(
        self,
        image_embeddings: torch.Tensor,  # (B, S, S, C) NHWC
        image_pe: torch.Tensor,  # (1 or B, S, S, C)
        sparse_prompt: torch.Tensor,  # (B, P, T, C)
        dense_prompt: torch.Tensor,  # (B, S, S, C)
        high_res_feats: tuple[torch.Tensor, torch.Tensor],  # NHWC (4S,4S,C/8), (2S,2S,C/4)
        multimask_output: bool,
    ):
        hs = self.cfg.prompt_hidden_size
        num_mask_tokens = self.num_mask_tokens
        B, S = image_embeddings.shape[0], image_embeddings.shape[1]
        P = sparse_prompt.shape[1]

        output_tokens = torch.cat(
            [self.obj_score_token.weight, self.iou_token.weight, self.mask_tokens.weight], dim=0
        )
        output_tokens = output_tokens[None, None].expand(B, P, *output_tokens.shape)
        tokens = torch.cat([output_tokens, sparse_prompt], dim=2)

        src = image_embeddings + dense_prompt
        src = src[:, None].expand(B, P, S, S, hs).reshape(B, P, S * S, hs)
        pe = image_pe[:, None].expand(B, P, S, S, hs).reshape(B, P, S * S, hs)

        point_out, image_out = self.transformer(tokens, src, pe)
        iou_token_out = point_out[:, :, 1, :]
        mask_tokens_out = point_out[:, :, 2 : 2 + num_mask_tokens, :]

        # Upscale image embedding (stride16 → stride4) with skip connections.
        img = image_out.reshape(B * P, S, S, hs)
        feat_s0, feat_s1 = high_res_feats
        feat_s0 = feat_s0.repeat_interleave(P, dim=0)
        feat_s1 = feat_s1.repeat_interleave(P, dim=0)
        up = _conv_transpose_nhwc(self.upscale_conv1, img) + feat_s1
        up = F.gelu(self.upscale_layer_norm(up))
        up = F.gelu(_conv_transpose_nhwc(self.upscale_conv2, up) + feat_s0)

        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, :, i, :]) for i, mlp in enumerate(self.output_hypernetworks_mlps)],
            dim=2,
        )  # (B, P, num_mask_tokens, C/8)
        Hu, Wu = up.shape[1], up.shape[2]
        up_flat = up.reshape(B, P, Hu * Wu, hs // 8)
        masks = torch.matmul(hyper_in, up_flat.transpose(-1, -2)).reshape(
            B, P, num_mask_tokens, Hu, Wu
        )

        iou_pred = self.iou_prediction_head(iou_token_out)
        object_score_logits = self.pred_obj_score_head(point_out[:, :, 0, :])

        if multimask_output:
            masks = masks[:, :, 1:]
            iou_pred = iou_pred[:, :, 1:]
        elif self.cfg.dynamic_multimask_via_stability:
            masks, iou_pred = self._dynamic_multimask(masks, iou_pred)
        else:
            masks = masks[:, :, 0:1]
            iou_pred = iou_pred[:, :, 0:1]

        return masks, iou_pred, object_score_logits

    def _dynamic_multimask(self, all_masks, all_iou):
        """Fall back to best multimask output when the single mask is unstable."""
        cfg = self.cfg
        multimask = all_masks[:, :, 1:]
        multi_iou = all_iou[:, :, 1:]
        best = torch.argmax(multi_iou, dim=-1)  # (B,P)
        Hm, Wm = multimask.shape[-2:]
        best_masks = torch.gather(
            multimask, 2, best[..., None, None, None].expand(*best.shape, 1, Hm, Wm)
        )  # (B,P,1,H,W)
        best_iou = torch.gather(multi_iou, 2, best[..., None])

        single = all_masks[:, :, 0:1]
        single_iou = all_iou[:, :, 0:1]
        delta = cfg.dynamic_multimask_stability_delta
        flat = single.reshape(*single.shape[:3], -1)
        area_i = (flat > delta).sum(dim=-1).float()
        area_u = (flat > -delta).sum(dim=-1).float()
        stability = torch.where(area_u > 0, area_i / area_u, torch.ones_like(area_u))
        is_stable = stability >= cfg.dynamic_multimask_stability_thresh

        masks = torch.where(is_stable[..., None, None], single, best_masks)
        iou = torch.where(is_stable, single_iou, best_iou)
        return masks, iou
