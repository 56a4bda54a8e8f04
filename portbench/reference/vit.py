"""A plain Virchow2-style Vision Transformer in float32 PyTorch.

timm's ``VisionTransformer`` as Virchow2 configures it: a 14 px patch
convolution; a class token and register tokens prepended after the learned
positional embedding, which covers the patch tokens only; pre-norm blocks of
multi-head attention and a packed SwiGLU MLP (``fc1`` gives the gate's input
and the value, act(first half) * second half), each branch scaled by a
LayerScale; a final LayerNorm; the output is the class token concatenated
with the mean of the patch tokens (registers left out). Parameter names are
those of the configuration's state_dict layout. Attention is the textbook
softmax(QK^T / sqrt(d)) V, all in float32.

``quant_bits`` fakes W(b)A(b) serving, for a control: every block linear's
weight rounded per output channel and its input per row to ``bits``-bit
symmetric integers (scale = absmax / (2^(b-1) - 1)), products and the rest in
float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def fake_quant(x: torch.Tensor, bits: int, dim: int = -1) -> torch.Tensor:
    q = 2 ** (bits - 1) - 1
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / q
    return torch.round(x / scale).clamp(-q, q) * scale


class Linear(nn.Linear):
    bits: int | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bits is None:
            return super().forward(x)
        return F.linear(fake_quant(x, self.bits), fake_quant(self.weight, self.bits), self.bias)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int) -> None:
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        q, k, v = self.qkv(x).reshape(B, T, 3, self.heads, C // self.heads).permute(2, 0, 3, 1, 4)
        scores = (q @ k.transpose(-1, -2)) * (C // self.heads) ** -0.5
        out = scores.softmax(dim=-1) @ v
        return self.proj(out.transpose(1, 2).reshape(B, T, C))


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = Linear(dim, 2 * hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(F.silu(a) * b)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, eps: float) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = SwiGLU(dim, hidden)
        self.ls1 = nn.Parameter(torch.ones(dim))
        self.ls2 = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x)) * self.ls1
        return x + self.mlp(self.norm2(x)) * self.ls2


class ViT(nn.Module):
    """(B, S, S, 3) normalized NHWC images → (B, 2 * dim) features."""

    def __init__(self, cfg: dict) -> None:
        super().__init__()
        dim, p = cfg["hidden_size"], cfg["patch_size"]
        self.reg = cfg["reg_tokens"]
        self.patch_embed = nn.Conv2d(3, dim, p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.reg_token = nn.Parameter(torch.zeros(1, self.reg, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (cfg["img_size"] // p) ** 2, dim))
        self.blocks = nn.ModuleList(
            Block(dim, cfg["num_attention_heads"], cfg["intermediate_size"], cfg["layer_norm_eps"])
            for _ in range(cfg["num_hidden_layers"])
        )
        self.norm = nn.LayerNorm(dim, eps=cfg["layer_norm_eps"])

    def set_quant_bits(self, bits: int | None) -> None:
        for m in self.blocks.modules():
            if isinstance(m, Linear):
                m.bits = bits

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B = images.shape[0]
        x = self.patch_embed(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2) + self.pos_embed
        x = torch.cat([self.cls_token.expand(B, -1, -1), self.reg_token.expand(B, -1, -1), x], dim=1)
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        return torch.cat([x[:, 0], x[:, 1 + self.reg :].mean(dim=1)], dim=-1)


def preprocess(patch, cfg: dict) -> torch.Tensor:
    """An (h, w, 3) uint8 patch → (S, S, 3) float32 normalized, by Pillow's
    resize and the configured mean and standard deviation."""
    import numpy as np
    from PIL import Image

    pre = cfg["preprocess"]
    img = Image.fromarray(patch)
    size = (pre["size"], pre["size"])
    if img.size != size:
        img = img.resize(size, getattr(Image.Resampling, pre["interpolation"].upper()))
    x = torch.from_numpy(np.asarray(img, dtype=np.float32) / 255.0)
    return (x - torch.tensor(pre["mean"])) / torch.tensor(pre["std"])
