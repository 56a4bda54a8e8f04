"""Swin Transformer (tiny) with the CHIEF-CTransPath ConvStem, in PyTorch.

The port of ``atlaspatch_tpu/models/encoders/swin.py``. Covers the
`chief-ctranspath` encoder (reference: atlas_patch/models/patch/
chief_ctranspath.py:64-186): a 3-conv stem (3x3 s2 + BN + ReLU twice, then 1x1
to embed_dim) replaces the patch embed of swin_tiny_patch4_window7_224; output
is the final-norm feature map mean-pooled over space → 768.

The window geometry (relative-position indices, the shifted windows' −100
masks) is static, computed with numpy when the module is built and held in
non-persistent buffers. Attention keeps the JAX cast points: the scaled
product in the compute dtype, the position bias and the mask added in it,
then a float32 softmax. The stem runs channels-last on cuDNN; the blocks
work on (B, H, W, C), as the JAX code does.

Module names mirror the Flax tree (``stem_conv0``, ``stage{s}_block{b}``,
``merge{s}``), so :func:`flax_swin_to_torch` is the shared walker;
:func:`timm_swin_to_flax` (with CHIEF's old→new downsample remap) and
:func:`hf_swin_to_flax` are copies of the JAX converters.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from atlaspatch_tpu_torch.models.encoders.convert import _lin, _ln, _np
from atlaspatch_tpu_torch.models.encoders.resnet import FrozenBatchNorm
from atlaspatch_tpu_torch.models.encoders.vit import flax_tree_to_torch


@dataclass(frozen=True)
class SwinSpec:
    img_size: int = 224
    patch_size: int = 4
    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    heads: tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    conv_stem: bool = True  # CHIEF ConvStem vs plain conv patchify
    ln_eps: float = 1e-5

    @property
    def embedding_dim(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


def _rel_pos_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    coords_flat = coords.reshape(2, -1)
    rel = coords_flat[:, :, None] - coords_flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)  # (T, T)


def _shift_attn_mask(resolution: int, window: int, shift: int) -> np.ndarray | None:
    if shift == 0:
        return None
    img_mask = np.zeros((resolution, resolution), np.int32)
    cnt = 0
    for h_slice in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for w_slice in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[h_slice, w_slice] = cnt
            cnt += 1
    n = resolution // window
    windows = img_mask.reshape(n, window, n, window).transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)  # (nW, T, T)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int) -> None:
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("rel_index", torch.tensor(_rel_pos_index(window).reshape(-1)),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """x: (B*nW, T, C); mask: (nW, T, T) or None."""
        Bn, T, C = x.shape
        head_dim = self.dim // self.heads
        q, k, v = self.qkv(x).reshape(Bn, T, 3, self.heads, head_dim).permute(2, 0, 3, 1, 4).unbind(0)
        attn = torch.einsum("bhqd,bhkd->bhqk", q, k) * (head_dim**-0.5)
        bias = self.rel_pos_table[self.rel_index].reshape(T, T, self.heads).permute(2, 0, 1)
        attn = attn + bias[None].to(attn.dtype)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(Bn // nW, nW, self.heads, T, T) + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(Bn, self.heads, T, T)
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        return self.proj(out.transpose(1, 2).reshape(Bn, T, C))


class SwinBlock(nn.Module):
    def __init__(self, spec: SwinSpec, dim: int, heads: int, resolution: int, shift: int) -> None:
        super().__init__()
        self.window = min(spec.window, resolution)
        self.shift = shift if resolution > self.window else 0
        self.norm1 = nn.LayerNorm(dim, eps=spec.ln_eps)
        self.attn = WindowAttention(dim, heads, self.window)
        self.norm2 = nn.LayerNorm(dim, eps=spec.ln_eps)
        self.fc1 = nn.Linear(dim, int(dim * spec.mlp_ratio))
        self.fc2 = nn.Linear(int(dim * spec.mlp_ratio), dim)
        mask = _shift_attn_mask(resolution, self.window, self.shift)
        self.register_buffer("attn_mask", None if mask is None else torch.tensor(mask), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        window, shift = self.window, self.shift
        h = self.norm1(x)
        if shift:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        n = H // window
        hw = h.reshape(B, n, window, n, window, C).permute(0, 1, 3, 2, 4, 5)
        hw = self.attn(hw.reshape(B * n * n, window * window, C), self.attn_mask)
        h = hw.reshape(B, n, n, window, window, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
        if shift:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + h
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, out_dim: int, ln_eps: float) -> None:
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=ln_eps)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinNet(nn.Module):
    """(B, S, S, 3) normalized images → (B, embedding_dim) spatial-mean features."""

    def __init__(self, spec: SwinSpec) -> None:
        super().__init__()
        s = self.spec = spec
        if s.conv_stem:
            c = s.embed_dim // 8
            self.stem_conv0 = nn.Conv2d(3, c, 3, stride=2, padding=1, bias=False)
            self.stem_bn0 = FrozenBatchNorm(c)
            self.stem_conv1 = nn.Conv2d(c, 2 * c, 3, stride=2, padding=1, bias=False)
            self.stem_bn1 = FrozenBatchNorm(2 * c)
            self.stem_proj = nn.Conv2d(2 * c, s.embed_dim, 1)
        else:
            self.stem_proj = nn.Conv2d(3, s.embed_dim, s.patch_size, stride=s.patch_size)
        self.patch_norm = nn.LayerNorm(s.embed_dim, eps=s.ln_eps)
        resolution, dim = s.img_size // s.patch_size, s.embed_dim
        for stage, depth in enumerate(s.depths):
            if stage > 0:
                self.add_module(f"merge{stage}", PatchMerging(dim, 2 * dim, s.ln_eps))
                dim *= 2
                resolution //= 2
            for b in range(depth):
                shift = 0 if b % 2 == 0 else min(s.window, resolution) // 2
                self.add_module(f"stage{stage}_block{b}", SwinBlock(s, dim, s.heads[stage], resolution, shift))
        self.norm = nn.LayerNorm(dim, eps=s.ln_eps)
        self.to(memory_format=torch.channels_last)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        s = self.spec
        x = images.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        if s.conv_stem:
            x = F.relu(self.stem_bn0(self.stem_conv0(x)))
            x = F.relu(self.stem_bn1(self.stem_conv1(x)))
        x = self.patch_norm(self.stem_proj(x).permute(0, 2, 3, 1))  # (B, H, W, C)
        for stage, depth in enumerate(s.depths):
            if stage > 0:
                x = getattr(self, f"merge{stage}")(x)
            for b in range(depth):
                x = getattr(self, f"stage{stage}_block{b}")(x)
        return self.norm(x).mean(dim=(1, 2))


flax_swin_to_torch = flax_tree_to_torch


# --- converters ----------------------------------------------------------------------
def timm_swin_to_flax(sd, spec: SwinSpec) -> dict:
    """timm swin naming (new layout: layer i >= 1 holds its own downsample),
    which is what the CHIEF checkpoint is loaded into after the reference's
    key remap (chief_ctranspath.py:141-151). The remap is applied here when
    the dict still uses the old layout."""
    # Apply the CHIEF old→new downsample remap when needed.
    if any(k.startswith("layers.0.downsample.") for k in sd):
        remapped = {}
        for k, v in sd.items():
            for i in (2, 1, 0):
                old = f"layers.{i}.downsample."
                if k.startswith(old):
                    k = k.replace(f"layers.{i}.", f"layers.{i + 1}.")
                    break
            remapped[k] = v
        sd = remapped
    sd = {k: v for k, v in sd.items()
          if "relative_position_index" not in k and "attn_mask" not in k}

    params: dict = {"patch_norm": _ln(sd, "patch_embed.norm"), "norm": _ln(sd, "norm")}
    if spec.conv_stem:
        params["stem_conv0"] = {"kernel": _np(sd["patch_embed.proj.0.weight"]).transpose(2, 3, 1, 0)}
        params["stem_bn0"] = {
            "scale": _np(sd["patch_embed.proj.1.weight"]),
            "bias": _np(sd["patch_embed.proj.1.bias"]),
            "mean": _np(sd["patch_embed.proj.1.running_mean"]),
            "var": _np(sd["patch_embed.proj.1.running_var"]),
        }
        params["stem_conv1"] = {"kernel": _np(sd["patch_embed.proj.3.weight"]).transpose(2, 3, 1, 0)}
        params["stem_bn1"] = {
            "scale": _np(sd["patch_embed.proj.4.weight"]),
            "bias": _np(sd["patch_embed.proj.4.bias"]),
            "mean": _np(sd["patch_embed.proj.4.running_mean"]),
            "var": _np(sd["patch_embed.proj.4.running_var"]),
        }
        params["stem_proj"] = {
            "kernel": _np(sd["patch_embed.proj.6.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(sd["patch_embed.proj.6.bias"]),
        }
    else:
        params["stem_proj"] = {
            "kernel": _np(sd["patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(sd["patch_embed.proj.bias"]),
        }

    for stage in range(len(spec.depths)):
        if stage > 0:
            params[f"merge{stage}"] = {
                "norm": _ln(sd, f"layers.{stage}.downsample.norm"),
                "reduction": _lin(sd, f"layers.{stage}.downsample.reduction", bias=False),
            }
        for b in range(spec.depths[stage]):
            p = f"layers.{stage}.blocks.{b}"
            params[f"stage{stage}_block{b}"] = {
                "norm1": _ln(sd, f"{p}.norm1"),
                "norm2": _ln(sd, f"{p}.norm2"),
                "attn": {
                    "qkv": _lin(sd, f"{p}.attn.qkv"),
                    "proj": _lin(sd, f"{p}.attn.proj"),
                    "rel_pos_table": _np(sd[f"{p}.attn.relative_position_bias_table"]),
                },
                "fc1": _lin(sd, f"{p}.mlp.fc1"),
                "fc2": _lin(sd, f"{p}.mlp.fc2"),
            }
    return params


def hf_swin_to_flax(sd, spec: SwinSpec, prefix: str = "") -> dict:
    """transformers SwinModel naming (plain conv patchify stem)."""
    g = lambda k: prefix + k  # noqa: E731
    params: dict = {
        "stem_proj": {
            "kernel": _np(sd[g("embeddings.patch_embeddings.projection.weight")]).transpose(2, 3, 1, 0),
            "bias": _np(sd[g("embeddings.patch_embeddings.projection.bias")]),
        },
        "patch_norm": _ln(sd, g("embeddings.norm")),
        "norm": _ln(sd, g("layernorm")),
    }
    for stage in range(len(spec.depths)):
        # HF stores downsample at the END of stage `stage` — our merge{stage+1}
        if f"{prefix}encoder.layers.{stage}.downsample.reduction.weight" in sd:
            params[f"merge{stage + 1}"] = {
                "norm": _ln(sd, g(f"encoder.layers.{stage}.downsample.norm")),
                "reduction": _lin(
                    sd, g(f"encoder.layers.{stage}.downsample.reduction"), bias=False
                ),
            }
        for b in range(spec.depths[stage]):
            p = g(f"encoder.layers.{stage}.blocks.{b}")
            q_w = _np(sd[f"{p}.attention.self.query.weight"]).T
            k_w = _np(sd[f"{p}.attention.self.key.weight"]).T
            v_w = _np(sd[f"{p}.attention.self.value.weight"]).T
            q_b = _np(sd[f"{p}.attention.self.query.bias"])
            k_b = _np(sd[f"{p}.attention.self.key.bias"])
            v_b = _np(sd[f"{p}.attention.self.value.bias"])
            params[f"stage{stage}_block{b}"] = {
                "norm1": _ln(sd, f"{p}.layernorm_before"),
                "norm2": _ln(sd, f"{p}.layernorm_after"),
                "attn": {
                    "qkv": {
                        "kernel": np.concatenate([q_w, k_w, v_w], axis=1),
                        "bias": np.concatenate([q_b, k_b, v_b]),
                    },
                    "proj": _lin(sd, f"{p}.attention.output.dense"),
                    "rel_pos_table": _np(
                        sd[f"{p}.attention.self.relative_position_bias_table"]
                    ),
                },
                "fc1": _lin(sd, f"{p}.intermediate.dense"),
                "fc2": _lin(sd, f"{p}.output.dense"),
            }
    return params
