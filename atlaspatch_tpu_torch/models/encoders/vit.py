"""Unified Vision Transformer in PyTorch covering the encoder zoo's ViT variants.

The port of ``atlaspatch_tpu/models/encoders/vit.py``. One parameterized
implementation spans torchvision ViT-B/L/H, DINOv2 (+LayerScale), DINOv3
(axial RoPE, gated MLP), the timm pathology models (register tokens,
LayerScale, SwiGLU-packed MLPs, SiLU), Phikon/Hibou, Lunit DINO ViTs, and the
CLIP/SigLIP visual towers (pre-LN, QuickGELU, attention-pool head,
projection).

Numerics follow the reference's cast points: attention is QK^T in the compute
dtype, times the scale, a float32 softmax, the probabilities cast back to the
compute dtype, then PV, in the token-major (B, T, H, D) layout
(reference vit.py:263-265). The products run on cuBLAS / cuDNN through
``F.linear``, ``torch.einsum`` and ``F.conv2d``.

The state_dict mirrors the Flax param tree (``blocks_{i}`` → ``blocks.{i}``,
Dense ``kernel`` → ``weight`` transposed, LayerNorm ``scale`` → ``weight``);
:func:`flax_vit_to_torch` converts one to the other. The int8 serving mode
(``Int8Dense``, ``quantize_vit_params``) is not ported: a spec with
``quant_int8`` raises.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class ViTSpec:
    img_size: int = 224
    patch_size: int = 16
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    mlp_hidden: int | None = None  # explicit hidden dim overrides ratio
    qkv_bias: bool = True
    layerscale: bool = False
    reg_tokens: int = 0
    class_token: bool = True
    swiglu: bool = False
    act: str = "gelu"  # gelu | gelu_tanh | quick_gelu | silu
    pre_ln: bool = False  # CLIP-style LN right after embeddings
    final_norm: bool = True
    proj_dim: int | None = None  # CLIP projection from CLS
    pool: str = "cls"  # cls | mean | cls_mean_concat | map | none
    patch_bias: bool = True  # CLIP conv1 has no bias
    # Positional-embedding coverage:
    #   "prefix": cls + patches (standard ViT / DINOv2; registers get no pos)
    #   "patches": patches only, prefix prepended afterwards (timm no_embed_class)
    #   "all": cls + registers + patches
    #   "rope": no learned pos embed; DINOv3 axial RoPE on patch tokens
    pos_mode: str = "prefix"
    rope_theta: float = 100.0  # used when pos_mode == "rope"
    gated_mlp: bool = False  # DINOv3 GatedMLP: down(act(gate(x)) * up(x))
    ln_eps: float = 1e-6
    # The int8 serving mode of the JAX package; not ported (ViT raises).
    quant_int8: bool = False
    quant_int8_attn: bool = False

    @property
    def tokens(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def prefix_tokens(self) -> int:
        return (1 if self.class_token else 0) + self.reg_tokens

    @property
    def hidden_dim(self) -> int:
        return self.mlp_hidden if self.mlp_hidden is not None else int(self.dim * self.mlp_ratio)


def _act(name: str):
    """The activation by name. ``ATLASPATCH_GELU_TANH=1`` turns the exact erf
    GELU into the tanh approximation (the JAX package does so by default only
    in its int8 mode, which is not ported). Read when the module is built."""
    if name == "gelu" and os.environ.get("ATLASPATCH_GELU_TANH") == "1":
        name = "gelu_tanh"
    return {
        "gelu": lambda x: F.gelu(x),
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
        "silu": F.silu,
        "relu": F.relu,
    }[name]


def _rope_cos_sin(spec: ViTSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """DINOv3 axial RoPE tables for the static patch grid: (N_patches, head_dim),
    float32 on the CPU."""
    head_dim = spec.dim // spec.heads
    n = spec.img_size // spec.patch_size
    exponents = torch.from_numpy(np.arange(0, 1, 4 / head_dim, dtype=np.float32))
    inv_freq = 1.0 / spec.rope_theta**exponents
    coords_1d = (torch.arange(0.5, n, dtype=torch.float32, device="cpu") / n) * 2.0 - 1.0
    yy, xx = torch.meshgrid(coords_1d, coords_1d, indexing="ij")
    coords = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)  # (N, 2)
    angles = 2.0 * math.pi * coords[:, :, None] * inv_freq[None, None, :]
    angles = angles.reshape(angles.shape[0], -1).tile(1, 2)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, equation: str,
                       out_equation: str) -> torch.Tensor:
    """softmax(QK^T * scale) V with the reference's cast points: the product
    and the scale in the compute dtype, the softmax in float32."""
    attn = torch.einsum(equation, q, k) * (q.shape[-1] ** -0.5)
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    return torch.einsum(out_equation, attn, v)


class Attention(nn.Module):
    def __init__(self, spec: ViTSpec) -> None:
        super().__init__()
        self.spec = spec
        self.qkv = nn.Linear(spec.dim, 3 * spec.dim, bias=spec.qkv_bias)
        self.proj = nn.Linear(spec.dim, spec.dim)
        if spec.pos_mode == "rope":
            cos, sin = _rope_cos_sin(spec)
            self.register_buffer("rope_cos", cos, persistent=False)
            self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.spec
        B, T, _ = x.shape
        # token-major (B, T, H, D) throughout, as the reference keeps it
        q, k, v = self.qkv(x).reshape(B, T, 3, s.heads, s.dim // s.heads).unbind(2)
        if s.pos_mode == "rope":
            cos = self.rope_cos.to(q.dtype)[None, :, None, :]  # (1, T_patch, 1, D)
            sin = self.rope_sin.to(q.dtype)[None, :, None, :]
            n_prefix = T - cos.shape[1]
            qp, kp = q[:, n_prefix:], k[:, n_prefix:]
            qp = qp * cos + _rotate_half(qp) * sin
            kp = kp * cos + _rotate_half(kp) * sin
            q = torch.cat([q[:, :n_prefix], qp], dim=1)
            k = torch.cat([k[:, :n_prefix], kp], dim=1)
        out = _softmax_attention(q, k, v, "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd")
        return self.proj(out.reshape(B, T, s.dim))


class Mlp(nn.Module):
    def __init__(self, spec: ViTSpec) -> None:
        super().__init__()
        self.spec = spec
        self.act = _act(spec.act)
        hidden = spec.hidden_dim
        if spec.gated_mlp:
            self.fc_gate = nn.Linear(spec.dim, hidden)
            self.fc_up = nn.Linear(spec.dim, hidden)
        else:
            self.fc1 = nn.Linear(spec.dim, 2 * hidden if spec.swiglu else hidden)
        self.fc2 = nn.Linear(hidden, spec.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spec.gated_mlp:
            h = self.act(self.fc_gate(x)) * self.fc_up(x)
        elif self.spec.swiglu:
            x1, x2 = self.fc1(x).chunk(2, dim=-1)
            h = self.act(x1) * x2
        else:
            h = self.act(self.fc1(x))
        return self.fc2(h)


class Block(nn.Module):
    def __init__(self, spec: ViTSpec) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(spec.dim, eps=spec.ln_eps)
        self.attn = Attention(spec)
        self.norm2 = nn.LayerNorm(spec.dim, eps=spec.ln_eps)
        self.mlp = Mlp(spec)
        if spec.layerscale:
            self.ls1 = nn.Parameter(torch.ones(spec.dim))
            self.ls2 = nn.Parameter(torch.ones(spec.dim))
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(self.norm1(x))
        if self.ls1 is not None:
            h = h * self.ls1
        x = x + h
        h = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            h = h * self.ls2
        return x + h


class MAPHead(nn.Module):
    """SigLIP attention-pooling head: probe token cross-attends all tokens."""

    def __init__(self, spec: ViTSpec) -> None:
        super().__init__()
        self.spec = spec
        self.probe = nn.Parameter(torch.zeros(1, 1, spec.dim))
        self.q_proj = nn.Linear(spec.dim, spec.dim)
        self.k_proj = nn.Linear(spec.dim, spec.dim)
        self.v_proj = nn.Linear(spec.dim, spec.dim)
        self.out_proj = nn.Linear(spec.dim, spec.dim)
        self.norm = nn.LayerNorm(spec.dim, eps=spec.ln_eps)
        self.mlp = Mlp(spec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.spec
        B = x.shape[0]

        def split(t):
            return t.reshape(B, -1, s.heads, s.dim // s.heads).transpose(1, 2)

        q = self.q_proj(self.probe.expand(B, 1, s.dim))
        out = _softmax_attention(split(q), split(self.k_proj(x)), split(self.v_proj(x)),
                                 "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd")
        out = self.out_proj(out.transpose(1, 2).reshape(B, 1, s.dim))
        return (out + self.mlp(self.norm(out)))[:, 0]


class ViT(nn.Module):
    """(B, S, S, 3) normalized images (NHWC, as the reference takes them) →
    (B, D) features per ``spec.pool``."""

    def __init__(self, spec: ViTSpec) -> None:
        super().__init__()
        if spec.quant_int8:
            raise NotImplementedError(
                "the int8 ViT (Int8Dense, quantize_vit_params) is not ported to "
                "atlaspatch_tpu_torch yet (ROADMAP queue 1, item 8)"
            )
        if spec.pos_mode not in ("prefix", "patches", "all", "rope"):
            raise ValueError(f"unknown pos_mode {spec.pos_mode}")
        if spec.pool not in ("cls", "mean", "cls_mean_concat", "map", "none"):
            raise ValueError(f"unknown pool {spec.pool}")
        s = self.spec = spec
        self.patch_embed = nn.Conv2d(3, s.dim, s.patch_size, stride=s.patch_size, bias=s.patch_bias)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, s.dim)) if s.class_token else None
        self.reg_token = nn.Parameter(torch.zeros(1, s.reg_tokens, s.dim)) if s.reg_tokens else None
        n_pos = {"patches": s.tokens, "prefix": s.tokens + (1 if s.class_token else 0),
                 "all": s.tokens + s.prefix_tokens, "rope": 0}[s.pos_mode]
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, s.dim)) if n_pos else None
        self.ln_pre = nn.LayerNorm(s.dim, eps=s.ln_eps) if s.pre_ln else None
        self.blocks = nn.ModuleList(Block(s) for _ in range(s.depth))
        self.norm = nn.LayerNorm(s.dim, eps=s.ln_eps) if s.final_norm else None
        self.head = MAPHead(s) if s.pool == "map" else None
        self.proj = nn.Linear(s.dim, s.proj_dim, bias=False) if s.proj_dim is not None else None

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        s = self.spec
        B = images.shape[0]
        x = self.patch_embed(images.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # row-major tokens, (B, N, D)

        prefix = []
        if self.cls_token is not None:
            prefix.append(self.cls_token.expand(B, 1, s.dim).to(x.dtype))
        if self.reg_token is not None:
            prefix.append(self.reg_token.expand(B, s.reg_tokens, s.dim).to(x.dtype))

        if s.pos_mode == "rope":
            x = torch.cat(prefix + [x], dim=1)
        else:
            pos = self.pos_embed.to(x.dtype)
            if s.pos_mode == "patches":
                x = torch.cat(prefix + [x + pos], dim=1)
            elif s.pos_mode == "all":
                x = torch.cat(prefix + [x], dim=1) + pos
            elif s.class_token:  # "prefix": pos covers cls+patches; registers after cls
                x = torch.cat([prefix[0], x], dim=1) + pos
                if s.reg_tokens:
                    x = torch.cat([x[:, :1], prefix[1], x[:, 1:]], dim=1)
            else:
                x = torch.cat(prefix + [x + pos], dim=1)

        if self.ln_pre is not None:
            x = self.ln_pre(x)
        for block in self.blocks:
            x = block(x)
        if self.norm is not None:
            x = self.norm(x)

        if s.pool == "none":
            return x
        if s.pool == "cls":
            out = x[:, 0]
        elif s.pool == "mean":
            out = x[:, s.prefix_tokens :].mean(dim=1)
        elif s.pool == "cls_mean_concat":
            out = torch.cat([x[:, 0], x[:, s.prefix_tokens :].mean(dim=1)], dim=-1)
        else:
            out = self.head(x)
        if self.proj is not None:
            out = self.proj(out)
        return out


def flax_tree_to_torch(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A param tree of the JAX package's (numpy or jax arrays) → the
    state_dict of the module that mirrors its names: ``blocks_{i}`` →
    ``blocks.{i}``; Dense kernels (in, out) → weight (out, in); Conv kernels
    (kh, kw, in, out) → weight (out, in, kh, kw); LayerNorm and BatchNorm
    ``scale`` → ``weight``; BatchNorm ``mean`` / ``var`` → ``running_mean`` /
    ``running_var``; everything else as it is. The ViT and the other towers
    of the zoo (Swin, CLIP ModifiedResNet, CoCa, BEiT3) use it.

    float32 leaves are not copied: a kernel's weight is a transposed view of
    it (``load_state_dict`` copies into the module), so a tree that is itself
    a view of a checkpoint (``convert._lin``) costs no memory of its own."""
    renames = {"scale": "weight", "mean": "running_mean", "var": "running_var"}
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, value in node.items():
                key = str(key)
                if key.startswith("blocks_"):
                    key = f"blocks.{key[len('blocks_'):]}"
                walk(value, path + [key])
            return
        arr = np.asarray(node, dtype=np.float32)
        if not arr.flags.writeable:  # a jax array's view: torch wants its own
            arr = arr.copy()
        leaf = path[-1]
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            leaf = "weight"
        out[".".join(path[:-1] + [renames.get(leaf, leaf)])] = torch.from_numpy(arr)

    walk(params, [])
    return out


flax_vit_to_torch = flax_tree_to_torch
