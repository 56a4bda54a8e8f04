"""CoCa visual tower (open_clip) in PyTorch: ViT trunk + attentional pooler.

The port of ``atlaspatch_tpu/models/encoders/coca.py``. Covers `omiclip`
(open_clip coca_ViT-L-14 — reference: atlas_patch/models/patch/omiclip.py:
12-66, encode_image → 768) and `conch_v1` (CONCH's timm ViT-B/16 trunk with
its contrastive pooler — reference conch.py:20-65, 512-d). The trunk is the
port's ViT with ``pool="none"`` (its tokens); an AttentionalPooler's learned
queries (``ln_q``) cross-attend the LayerNormed tokens (``ln_k``) through
separate q/k/v projections (``kdim``/``vdim`` = the trunk's width); ``ln_post``
normalizes the pooled queries and token 0 is the image latent, optionally
projected. Attention keeps the JAX cast points (the scaled product in the
compute dtype, a float32 softmax).

Module names mirror the Flax tree (``trunk``, ``attn_pool``, ``ln_post``),
so :func:`flax_coca_to_torch` is the shared walker; :func:`conch_v1_to_flax`
and :func:`open_clip_coca_to_flax` are the JAX converters' copies.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from atlaspatch_tpu_torch.models.encoders import convert as C
from atlaspatch_tpu_torch.models.encoders.convert import _np
from atlaspatch_tpu_torch.models.encoders.vit import ViT, ViTSpec, flax_tree_to_torch


@dataclass(frozen=True)
class CoCaSpec:
    trunk: ViTSpec
    n_queries: int = 256
    pooler_heads: int = 8
    output_dim: int = 768
    has_proj: bool = False  # proj after pooled token


def conch_v1_spec() -> CoCaSpec:
    """CONCH v1 (reference: conch.py:20-65): CoCa with a timm ViT-B/16 trunk and
    a single-query contrastive attentional pooler → 512-d (proj_contrast=False,
    normalize=False). Naming verified lazily at checkpoint-load time."""
    trunk = ViTSpec(
        img_size=224,
        patch_size=16,
        dim=768,
        depth=12,
        heads=12,
        act="gelu",
        final_norm=True,  # timm trunk keeps its final norm
        pool="none",
        ln_eps=1e-5,
    )
    return CoCaSpec(trunk=trunk, n_queries=1, pooler_heads=8, output_dim=512)


def coca_vit_l14_spec() -> CoCaSpec:
    trunk = ViTSpec(
        img_size=224,
        patch_size=14,
        dim=1024,
        depth=24,
        heads=16,
        act="gelu",
        pre_ln=True,
        patch_bias=False,
        final_norm=False,  # ln_post applies after pooling in CoCa
        pool="none",
        ln_eps=1e-5,
    )
    return CoCaSpec(trunk=trunk, n_queries=256, pooler_heads=8, output_dim=768)


class AttentionalPooler(nn.Module):
    def __init__(self, d_model: int, context_dim: int, heads: int, n_queries: int,
                 ln_eps: float = 1e-5) -> None:
        super().__init__()
        self.d_model, self.heads, self.n_queries = d_model, heads, n_queries
        self.query = nn.Parameter(torch.zeros(n_queries, d_model))
        self.ln_k = nn.LayerNorm(context_dim, eps=ln_eps)
        self.ln_q = nn.LayerNorm(d_model, eps=ln_eps)
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(context_dim, d_model)
        self.v_proj = nn.Linear(context_dim, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, context_dim) tokens → (B, n_queries, d_model)."""
        B = x.shape[0]
        x = self.ln_k(x)
        q_in = self.ln_q(self.query)[None].expand(B, self.n_queries, self.d_model).to(x.dtype)
        head_dim = self.d_model // self.heads

        def split(t):
            return t.reshape(B, -1, self.heads, head_dim).transpose(1, 2)

        attn = torch.einsum("bhqd,bhkd->bhqk", split(self.q_proj(q_in)), split(self.k_proj(x))) * (head_dim**-0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, split(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(B, self.n_queries, self.d_model))


class CoCaVisual(nn.Module):
    """(B, S, S, 3) normalized images → (B, output_dim): the pooler's token 0."""

    def __init__(self, spec: CoCaSpec) -> None:
        super().__init__()
        self.spec = spec
        self.trunk = ViT(spec.trunk)  # pool "none": (B, T, width) tokens
        self.attn_pool = AttentionalPooler(spec.output_dim, spec.trunk.dim, spec.pooler_heads,
                                           spec.n_queries, spec.trunk.ln_eps)
        self.ln_post = nn.LayerNorm(spec.output_dim, eps=spec.trunk.ln_eps)
        self.proj = nn.Linear(spec.output_dim, spec.output_dim, bias=False) if spec.has_proj else None

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        latent = self.ln_post(self.attn_pool(self.trunk(images)))[:, 0]
        return latent if self.proj is None else self.proj(latent)


flax_coca_to_torch = flax_tree_to_torch


def _pooler_to_flax(sd, g, d: int) -> dict:
    np_ = _np  # shared torch->numpy helper (convert.py)
    in_bias = np_(sd[g("attn.in_proj_bias")])
    return {
        "query": np_(sd[g("query")]),
        "ln_q": {"scale": np_(sd[g("ln_q.weight")]), "bias": np_(sd[g("ln_q.bias")])},
        "ln_k": {"scale": np_(sd[g("ln_k.weight")]), "bias": np_(sd[g("ln_k.bias")])},
        "q_proj": {"kernel": np_(sd[g("attn.q_proj_weight")]).T, "bias": in_bias[:d]},
        "k_proj": {"kernel": np_(sd[g("attn.k_proj_weight")]).T, "bias": in_bias[d : 2 * d]},
        "v_proj": {"kernel": np_(sd[g("attn.v_proj_weight")]).T, "bias": in_bias[2 * d :]},
        "out_proj": {
            "kernel": np_(sd[g("attn.out_proj.weight")]).T,
            "bias": np_(sd[g("attn.out_proj.bias")]),
        },
    }


def conch_v1_to_flax(sd, spec: CoCaSpec) -> dict:
    """CONCH v1 checkpoint → Flax params: timm ViT trunk under visual.trunk.*,
    contrastive pooler under visual.attn_pool_contrast.*, ln under
    visual.ln_contrast.*."""
    trunk_sd = {k[len("visual.trunk."):]: v for k, v in sd.items() if k.startswith("visual.trunk.")}
    return {
        "trunk": C.timm_vit_to_flax(trunk_sd, spec.trunk),
        "attn_pool": _pooler_to_flax(sd, lambda k: "visual.attn_pool_contrast." + k, spec.output_dim),
        "ln_post": {
            "scale": _np(sd["visual.ln_contrast.weight"]),
            "bias": _np(sd["visual.ln_contrast.bias"]),
        },
    }


def open_clip_coca_to_flax(sd, spec: CoCaSpec, prefix: str = "visual.") -> dict:
    """open_clip CoCa visual state dict → Flax params.

    Pooler MHA with kdim != embed_dim stores separate q/k/v projection weights
    (torch MultiheadAttention q_proj_weight / k_proj_weight / v_proj_weight +
    packed in_proj_bias).
    """
    trunk = C.open_clip_vit_to_flax(sd, spec.trunk, prefix=prefix)
    trunk.pop("norm", None)  # ln_post handled at the CoCa level
    proj = trunk.pop("proj", None)
    params: dict = {
        "trunk": trunk,
        "attn_pool": _pooler_to_flax(sd, lambda k: prefix + "attn_pool." + k, spec.output_dim),
        "ln_post": {
            "scale": _np(sd[f"{prefix}ln_post.weight"]),
            "bias": _np(sd[f"{prefix}ln_post.bias"]),
        },
    }
    if spec.has_proj and proj is not None:
        params["proj"] = proj
    return params
