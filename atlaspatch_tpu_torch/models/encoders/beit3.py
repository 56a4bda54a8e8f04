"""BEiT3 (torchscale) vision encoder in PyTorch — the MUSK tower.

The port of ``atlaspatch_tpu/models/encoders/beit3.py``. Covers `musk`
(reference: atlas_patch/models/patch/musk.py:12-85 — BEiT3-large at 384px,
Inception normalization). The multiway transformer degenerates to the
vision ("A") experts for image-only input; sub-LayerNorm (torchscale
`subln`) puts an extra LN after the attention context and inside the FFN.
Positions are fairseq-style with a 2-slot offset (token i reads row i + 2).
Attention scales q before QKᵀ, as torchscale does, then a float32 softmax.

:class:`MuskMsAug` is the tower with the MUSK wrapper's ms_aug=True forward
(:func:`musk_ms_aug_apply`, reference musk.py:60-70), so the engine runs it
as any other tower: per scale s, a bicubic upsample to s·384 with torch
semantics (a = −0.75, align_corners=False, no antialias), a chessboard split
into s² crops of 384 (crop (i, j) of image b at batch slot (i·s + j)·B + b),
the crops' CLS vectors averaged, and the scales concatenated: 2048-d for the
default scales (1, 2). The reference declares embedding_dim=1024
(musk.py:13) but stores the model's actual output, 2048-d; the zoo declares
the stored width.

Module names mirror the Flax tree, so :func:`flax_beit3_to_torch` is the
shared walker; :func:`musk_beit3_to_flax` is the JAX converter's copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from atlaspatch_tpu_torch.models.encoders.convert import _np
from atlaspatch_tpu_torch.models.encoders.vit import flax_tree_to_torch
from atlaspatch_tpu_torch.models.sam2.interp import interpolate_torch


@dataclass(frozen=True)
class Beit3Spec:
    img_size: int = 384
    patch_size: int = 16
    dim: int = 1024
    depth: int = 24
    heads: int = 16
    ffn_dim: int = 4096
    ln_eps: float = 1e-5
    final_norm: bool = True

    @property
    def tokens(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def embedding_dim(self) -> int:
        return self.dim


class Beit3Attention(nn.Module):
    def __init__(self, spec: Beit3Spec) -> None:
        super().__init__()
        self.spec = spec
        self.q_proj = nn.Linear(spec.dim, spec.dim)
        self.k_proj = nn.Linear(spec.dim, spec.dim)
        self.v_proj = nn.Linear(spec.dim, spec.dim)
        self.inner_attn_ln = nn.LayerNorm(spec.dim, eps=spec.ln_eps)  # subln
        self.out_proj = nn.Linear(spec.dim, spec.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.spec
        B, T, _ = x.shape
        head_dim = s.dim // s.heads

        def split(t):
            return t.reshape(B, T, s.heads, head_dim).transpose(1, 2)

        attn = torch.einsum("bhqd,bhkd->bhqk", split(self.q_proj(x)) * head_dim**-0.5, split(self.k_proj(x)))
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, split(self.v_proj(x)))
        return self.out_proj(self.inner_attn_ln(out.transpose(1, 2).reshape(B, T, s.dim)))


class Beit3Block(nn.Module):
    def __init__(self, spec: Beit3Spec) -> None:
        super().__init__()
        self.ln1 = nn.LayerNorm(spec.dim, eps=spec.ln_eps)
        self.attn = Beit3Attention(spec)
        self.ln2 = nn.LayerNorm(spec.dim, eps=spec.ln_eps)
        self.fc1 = nn.Linear(spec.dim, spec.ffn_dim)
        self.ffn_ln = nn.LayerNorm(spec.ffn_dim, eps=spec.ln_eps)  # subln
        self.fc2 = nn.Linear(spec.ffn_dim, spec.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.fc2(self.ffn_ln(F.gelu(self.fc1(self.ln2(x)))))


class Beit3Vision(nn.Module):
    """(B, S, S, 3) normalized images → (B, dim) CLS embedding."""

    def __init__(self, spec: Beit3Spec) -> None:
        super().__init__()
        s = self.spec = spec
        self.patch_embed = nn.Conv2d(3, s.dim, s.patch_size, stride=s.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, s.dim))
        # fairseq positional embedding: 2 reserved rows; token i uses row i + 2
        self.pos_embed = nn.Parameter(torch.zeros(s.tokens + 1 + 2, s.dim))
        self.blocks = nn.ModuleList(Beit3Block(s) for _ in range(s.depth))
        self.norm = nn.LayerNorm(s.dim, eps=s.ln_eps) if s.final_norm else None

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        s = self.spec
        B = images.shape[0]
        x = self.patch_embed(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)  # row-major tokens
        x = torch.cat([self.cls_token.expand(B, 1, s.dim).to(x.dtype), x], dim=1)
        x = x + self.pos_embed[2 : 2 + s.tokens + 1][None].to(x.dtype)
        for block in self.blocks:
            x = block(x)
        if self.norm is not None:
            x = self.norm(x)
        return x[:, 0]


def musk_ms_aug_apply(encode: Callable[[torch.Tensor], torch.Tensor], images: torch.Tensor,
                      scales: tuple[int, ...] = (1, 2)) -> torch.Tensor:
    """MUSK ms_aug=True forward (reference musk.py:60-70): multi-scale
    chessboard TTA over the vision tower ``encode``, mean CLS per scale,
    scales concatenated. No output normalization (the reference passes
    out_norm=False). images: (B, S, S, 3) normalized pixels."""
    B, S = images.shape[0], images.shape[1]
    outs = []
    for s in scales:
        if s == 1:
            cls = encode(images)
        else:
            up = interpolate_torch(images, (S * s, S * s), "bicubic")
            # chessboard split: crop (i, j) at batch slot (i*s + j)*B + b
            crops = up.reshape(B, s, S, s, S, -1).permute(1, 3, 0, 2, 4, 5).reshape(s * s * B, S, S, -1)
            cls = encode(crops)
            cls = cls.reshape(s * s, B, cls.shape[-1]).mean(dim=0)
        outs.append(cls)
    return torch.cat(outs, dim=-1)


class MuskMsAug(Beit3Vision):
    """The BEiT3 tower whose forward is :func:`musk_ms_aug_apply` over it:
    (B, S, S, 3) → (B, dim · len(scales)). Its state_dict is the tower's."""

    def __init__(self, spec: Beit3Spec, scales: tuple[int, ...] = (1, 2)) -> None:
        super().__init__(spec)
        self.scales = tuple(scales)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return musk_ms_aug_apply(super().forward, images, self.scales)


flax_beit3_to_torch = flax_tree_to_torch


def musk_beit3_to_flax(sd, spec: Beit3Spec) -> dict:
    """MUSK/torchscale state dict → Flax params (vision 'A' experts).

    Naming: beit3.vision_embed.{proj,cls_token}, beit3.encoder.embed_positions.A,
    beit3.encoder.layers.N.{self_attn.*, self_attn_layer_norm.A,
    ffn.A.{fc1,fc2,ffn_layernorm}, final_layer_norm.A}, beit3.encoder.layer_norm.A.
    """

    np_ = _np  # shared torch->numpy helper (convert.py)

    def pick(*keys):
        for k in keys:
            if k in sd:
                return sd[k]
        raise KeyError(keys[0])

    def lin(*keys):
        w = pick(*[f"{k}.weight" for k in keys])
        out = {"kernel": np_(w).T}
        for k in keys:
            if f"{k}.bias" in sd:
                out["bias"] = np_(sd[f"{k}.bias"])
                break
        return out

    def ln(*keys):
        return {
            "scale": np_(pick(*[f"{k}.weight" for k in keys])),
            "bias": np_(pick(*[f"{k}.bias" for k in keys])),
        }

    p = "beit3."
    params: dict = {
        "patch_embed": {
            "kernel": np_(sd[f"{p}vision_embed.proj.weight"]).transpose(2, 3, 1, 0),
            "bias": np_(sd[f"{p}vision_embed.proj.bias"]),
        },
        "cls_token": np_(sd[f"{p}vision_embed.cls_token"]),
        "pos_embed": np_(
            pick(f"{p}encoder.embed_positions.A.weight", f"{p}encoder.embed_positions.weight")
        ),
    }
    if f"{p}encoder.layer_norm.A.weight" in sd or f"{p}encoder.layer_norm.weight" in sd:
        params["norm"] = ln(f"{p}encoder.layer_norm.A", f"{p}encoder.layer_norm")
    for i in range(spec.depth):
        q = f"{p}encoder.layers.{i}"
        params[f"blocks_{i}"] = {
            "ln1": ln(f"{q}.self_attn_layer_norm.A", f"{q}.self_attn_layer_norm"),
            "ln2": ln(f"{q}.final_layer_norm.A", f"{q}.final_layer_norm"),
            "attn": {
                "q_proj": lin(f"{q}.self_attn.q_proj.A", f"{q}.self_attn.q_proj"),
                "k_proj": lin(f"{q}.self_attn.k_proj.A", f"{q}.self_attn.k_proj"),
                "v_proj": lin(f"{q}.self_attn.v_proj.A", f"{q}.self_attn.v_proj"),
                "out_proj": lin(f"{q}.self_attn.out_proj.A", f"{q}.self_attn.out_proj"),
                "inner_attn_ln": ln(
                    f"{q}.self_attn.inner_attn_ln.A", f"{q}.self_attn.inner_attn_ln"
                ),
            },
            "fc1": lin(f"{q}.ffn.A.fc1", f"{q}.ffn.fc1"),
            "fc2": lin(f"{q}.ffn.A.fc2", f"{q}.ffn.fc2"),
            "ffn_ln": ln(f"{q}.ffn.A.ffn_layernorm", f"{q}.ffn.ffn_layernorm"),
        }
    return params
