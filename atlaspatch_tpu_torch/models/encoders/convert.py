"""Checkpoint conversion for the encoder zoo's ViT-family sources.

The port of ``atlaspatch_tpu/models/encoders/convert.py``. Each ``*_to_flax``
is a copy of the JAX function: it maps one source naming scheme onto the
unified ViT param tree (the same tree the JAX package builds): timm
VisionTransformer (UNI/Virchow/H-optimus/GigaPath/PathOrchestra/Lunit),
transformers ViTModel (Phikon), Dinov2Model (DINOv2/Hibou/Midnight-style),
DINOv3ViTModel, open_clip visual towers (OpenAI CLIP/Quilt-PMB), the
open_clip timm-backed tower (BiomedCLIP), CLIPVisionModel (PLIP/Quilt),
SiglipVisionModel (MedSigLIP) and torchvision's VisionTransformer. Each
``*_to_torch`` carries that tree onto this package's ViT state_dict through
``vit.flax_vit_to_torch``.

Arrays are not copied where no concatenation is needed: a Linear weight
(out, in) becomes a Flax kernel by ``.T`` and back by ``.T``, both views, so
the state_dict shares the source tensor's memory.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from atlaspatch_tpu_torch.models.encoders.vit import flax_vit_to_torch


def _np(t: Any) -> np.ndarray:
    """torch tensor (any device/dtype, incl. bf16) or array-like -> numpy.

    The one tensor->numpy helper for every converter — keep fixes here."""
    if hasattr(t, "detach"):
        t = t.detach().cpu()
        if str(getattr(t, "dtype", "")) == "torch.bfloat16":
            t = t.float()  # numpy has no native bf16; converters store f32
        t = t.numpy()
    return np.asarray(t)


def _lin(sd, key, bias=True):
    out = {"kernel": _np(sd[f"{key}.weight"]).T}
    if bias and f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _ln(sd, key):
    return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}


def _patch_conv(sd, key, bias=True):
    out = {"kernel": _np(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)}
    if bias and f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _qkv_from_separate(sd, q, k, v, qkv_bias=True):
    kernel = np.concatenate([_np(sd[f"{p}.weight"]).T for p in (q, k, v)], axis=1)
    out = {"kernel": kernel}
    if qkv_bias and f"{q}.bias" in sd:
        out["bias"] = np.concatenate([_np(sd[f"{p}.bias"]) for p in (q, k, v)])
    return out


def _qkv_from_packed(sd, weight_key, bias_key):
    out = {"kernel": _np(sd[weight_key]).T}
    if bias_key in sd:
        out["bias"] = _np(sd[bias_key])
    return out


# --- timm VisionTransformer ----------------------------------------------------------
def timm_vit_to_flax(sd: Mapping[str, Any], spec) -> dict:
    params: dict[str, Any] = {
        "patch_embed": _patch_conv(sd, "patch_embed.proj"),
        "pos_embed": _np(sd["pos_embed"]),
        "norm": _ln(sd, "norm"),
    }
    if spec.class_token:
        params["cls_token"] = _np(sd["cls_token"])
    if spec.reg_tokens:
        params["reg_token"] = _np(sd["reg_token"])
    for i in range(spec.depth):
        p = f"blocks.{i}"
        block = {
            "norm1": _ln(sd, f"{p}.norm1"),
            "norm2": _ln(sd, f"{p}.norm2"),
            "attn": {
                "qkv": _qkv_from_packed(sd, f"{p}.attn.qkv.weight", f"{p}.attn.qkv.bias"),
                "proj": _lin(sd, f"{p}.attn.proj"),
            },
            "mlp": {"fc1": _lin(sd, f"{p}.mlp.fc1"), "fc2": _lin(sd, f"{p}.mlp.fc2")},
        }
        if spec.layerscale:
            block["ls1"] = _np(sd[f"{p}.ls1.gamma"])
            block["ls2"] = _np(sd[f"{p}.ls2.gamma"])
        params[f"blocks_{i}"] = block
    # Optional post-pool projection (CONCH v1.5 ViT-L/16 → 768): accept either
    # a bare matrix ("proj", open_clip orientation) or a Linear ("proj.weight").
    if getattr(spec, "proj_dim", None):
        if "proj" in sd:
            params["proj"] = {"kernel": _np(sd["proj"])}
        elif "proj.weight" in sd:
            params["proj"] = {"kernel": _np(sd["proj.weight"]).T}
    return params


# --- transformers ViTModel (and Phikon) ----------------------------------------------
def hf_vit_to_flax(sd: Mapping[str, Any], spec, prefix: str = "") -> dict:
    g = lambda k: prefix + k  # noqa: E731
    params: dict[str, Any] = {
        "patch_embed": _patch_conv(sd, g("embeddings.patch_embeddings.projection")),
        "cls_token": _np(sd[g("embeddings.cls_token")]),
        "pos_embed": _np(sd[g("embeddings.position_embeddings")]),
        "norm": _ln(sd, g("layernorm")),
    }
    for i in range(spec.depth):
        p = g(f"encoder.layer.{i}")
        params[f"blocks_{i}"] = {
            "norm1": _ln(sd, f"{p}.layernorm_before"),
            "norm2": _ln(sd, f"{p}.layernorm_after"),
            "attn": {
                "qkv": _qkv_from_separate(
                    sd,
                    f"{p}.attention.attention.query",
                    f"{p}.attention.attention.key",
                    f"{p}.attention.attention.value",
                ),
                "proj": _lin(sd, f"{p}.attention.output.dense"),
            },
            "mlp": {
                "fc1": _lin(sd, f"{p}.intermediate.dense"),
                "fc2": _lin(sd, f"{p}.output.dense"),
            },
        }
    return params


# --- transformers Dinov2Model --------------------------------------------------------
def hf_dinov2_to_flax(sd: Mapping[str, Any], spec, prefix: str = "") -> dict:
    g = lambda k: prefix + k  # noqa: E731
    params: dict[str, Any] = {
        "patch_embed": _patch_conv(sd, g("embeddings.patch_embeddings.projection")),
        "cls_token": _np(sd[g("embeddings.cls_token")]),
        "pos_embed": _np(sd[g("embeddings.position_embeddings")]),
        "norm": _ln(sd, g("layernorm")),
    }
    if spec.reg_tokens and g("embeddings.register_tokens") in sd:
        params["reg_token"] = _np(sd[g("embeddings.register_tokens")])
    for i in range(spec.depth):
        p = g(f"encoder.layer.{i}")
        if spec.swiglu:
            mlp = {
                "fc1": _lin(sd, f"{p}.mlp.weights_in"),
                "fc2": _lin(sd, f"{p}.mlp.weights_out"),
            }
        else:
            mlp = {"fc1": _lin(sd, f"{p}.mlp.fc1"), "fc2": _lin(sd, f"{p}.mlp.fc2")}
        params[f"blocks_{i}"] = {
            "norm1": _ln(sd, f"{p}.norm1"),
            "norm2": _ln(sd, f"{p}.norm2"),
            "attn": {
                "qkv": _qkv_from_separate(
                    sd,
                    f"{p}.attention.attention.query",
                    f"{p}.attention.attention.key",
                    f"{p}.attention.attention.value",
                ),
                "proj": _lin(sd, f"{p}.attention.output.dense"),
            },
            "mlp": mlp,
            "ls1": _np(sd[f"{p}.layer_scale1.lambda1"]),
            "ls2": _np(sd[f"{p}.layer_scale2.lambda1"]),
        }
    return params


# --- transformers DINOv3ViTModel -----------------------------------------------------
def hf_dinov3_to_flax(sd: Mapping[str, Any], spec, prefix: str = "") -> dict:
    """DINOv3 RoPE ViT: separate q/k/v with key bias absent (packed as zeros),
    layer-scale lambdas, plain or gated MLP, no learned positional embedding."""
    g = lambda k: prefix + k  # noqa: E731
    dim = spec.dim
    params: dict[str, Any] = {
        "patch_embed": _patch_conv(sd, g("embeddings.patch_embeddings")),
        "cls_token": _np(sd[g("embeddings.cls_token")]),
        "norm": _ln(sd, g("layernorm") if g("layernorm.weight") in sd else g("norm")),
    }
    if spec.reg_tokens:
        params["reg_token"] = _np(sd[g("embeddings.register_tokens")])
    for i in range(spec.depth):
        p = g(f"layer.{i}")
        q_w = _np(sd[f"{p}.attention.q_proj.weight"]).T
        k_w = _np(sd[f"{p}.attention.k_proj.weight"]).T
        v_w = _np(sd[f"{p}.attention.v_proj.weight"]).T
        q_b = _np(sd.get(f"{p}.attention.q_proj.bias", np.zeros(dim, np.float32)))
        k_b = _np(sd.get(f"{p}.attention.k_proj.bias", np.zeros(dim, np.float32)))
        v_b = _np(sd.get(f"{p}.attention.v_proj.bias", np.zeros(dim, np.float32)))
        if spec.gated_mlp:
            mlp = {
                "fc_gate": _lin(sd, f"{p}.mlp.gate_proj"),
                "fc_up": _lin(sd, f"{p}.mlp.up_proj"),
                "fc2": _lin(sd, f"{p}.mlp.down_proj"),
            }
        else:
            mlp = {
                "fc1": _lin(sd, f"{p}.mlp.up_proj"),
                "fc2": _lin(sd, f"{p}.mlp.down_proj"),
            }
        params[f"blocks_{i}"] = {
            "norm1": _ln(sd, f"{p}.norm1"),
            "norm2": _ln(sd, f"{p}.norm2"),
            "attn": {
                "qkv": {
                    "kernel": np.concatenate([q_w, k_w, v_w], axis=1),
                    "bias": np.concatenate([q_b, k_b, v_b]),
                },
                "proj": _lin(sd, f"{p}.attention.o_proj"),
            },
            "mlp": mlp,
            "ls1": _np(sd[f"{p}.layer_scale1.lambda1"]),
            "ls2": _np(sd[f"{p}.layer_scale2.lambda1"]),
        }
    return params


# --- open_clip visual tower ----------------------------------------------------------
def open_clip_vit_to_flax(sd: Mapping[str, Any], spec, prefix: str = "visual.") -> dict:
    g = lambda k: prefix + k  # noqa: E731
    params: dict[str, Any] = {
        "patch_embed": {"kernel": _np(sd[g("conv1.weight")]).transpose(2, 3, 1, 0)},
        "cls_token": _np(sd[g("class_embedding")]).reshape(1, 1, -1),
        "pos_embed": _np(sd[g("positional_embedding")])[None],
        "ln_pre": _ln(sd, g("ln_pre")),
        "norm": _ln(sd, g("ln_post")),
    }
    if g("proj") in sd:
        params["proj"] = {"kernel": _np(sd[g("proj")])}
    for i in range(spec.depth):
        p = g(f"transformer.resblocks.{i}")
        params[f"blocks_{i}"] = {
            "norm1": _ln(sd, f"{p}.ln_1"),
            "norm2": _ln(sd, f"{p}.ln_2"),
            "attn": {
                "qkv": _qkv_from_packed(
                    sd, f"{p}.attn.in_proj_weight", f"{p}.attn.in_proj_bias"
                ),
                "proj": _lin(sd, f"{p}.attn.out_proj"),
            },
            "mlp": {"fc1": _lin(sd, f"{p}.mlp.c_fc"), "fc2": _lin(sd, f"{p}.mlp.c_proj")},
        }
    return params


# --- transformers CLIPVisionModel(WithProjection) ------------------------------------
def hf_clip_to_flax(sd: Mapping[str, Any], spec, prefix: str = "vision_model.") -> dict:
    g = lambda k: prefix + k  # noqa: E731
    pre_ln_key = (
        g("pre_layrnorm") if g("pre_layrnorm.weight") in sd else g("pre_layernorm")
    )
    params: dict[str, Any] = {
        "patch_embed": {
            "kernel": _np(sd[g("embeddings.patch_embedding.weight")]).transpose(2, 3, 1, 0)
        },
        "cls_token": _np(sd[g("embeddings.class_embedding")]).reshape(1, 1, -1),
        "pos_embed": _np(sd[g("embeddings.position_embedding.weight")])[None],
        "ln_pre": _ln(sd, pre_ln_key),
        "norm": _ln(sd, g("post_layernorm")),
    }
    if "visual_projection.weight" in sd:
        params["proj"] = {"kernel": _np(sd["visual_projection.weight"]).T}
    for i in range(spec.depth):
        p = g(f"encoder.layers.{i}")
        params[f"blocks_{i}"] = {
            "norm1": _ln(sd, f"{p}.layer_norm1"),
            "norm2": _ln(sd, f"{p}.layer_norm2"),
            "attn": {
                "qkv": _qkv_from_separate(
                    sd, f"{p}.self_attn.q_proj", f"{p}.self_attn.k_proj", f"{p}.self_attn.v_proj"
                ),
                "proj": _lin(sd, f"{p}.self_attn.out_proj"),
            },
            "mlp": {"fc1": _lin(sd, f"{p}.mlp.fc1"), "fc2": _lin(sd, f"{p}.mlp.fc2")},
        }
    return params


# --- transformers SiglipVisionModel --------------------------------------------------
def hf_siglip_to_flax(sd: Mapping[str, Any], spec, prefix: str = "vision_model.") -> dict:
    g = lambda k: prefix + k  # noqa: E731
    params: dict[str, Any] = {
        "patch_embed": _patch_conv(sd, g("embeddings.patch_embedding")),
        "pos_embed": _np(sd[g("embeddings.position_embedding.weight")])[None],
        "norm": _ln(sd, g("post_layernorm")),
    }
    for i in range(spec.depth):
        p = g(f"encoder.layers.{i}")
        params[f"blocks_{i}"] = {
            "norm1": _ln(sd, f"{p}.layer_norm1"),
            "norm2": _ln(sd, f"{p}.layer_norm2"),
            "attn": {
                "qkv": _qkv_from_separate(
                    sd, f"{p}.self_attn.q_proj", f"{p}.self_attn.k_proj", f"{p}.self_attn.v_proj"
                ),
                "proj": _lin(sd, f"{p}.self_attn.out_proj"),
            },
            "mlp": {"fc1": _lin(sd, f"{p}.mlp.fc1"), "fc2": _lin(sd, f"{p}.mlp.fc2")},
        }
    # MAP head: torch nn.MultiheadAttention packs qkv; probe is a query token.
    hp = g("head")
    in_w = _np(sd[f"{hp}.attention.in_proj_weight"])
    in_b = _np(sd[f"{hp}.attention.in_proj_bias"])
    d = in_w.shape[1]
    params["head"] = {
        "probe": _np(sd[f"{hp}.probe"]),
        "q_proj": {"kernel": in_w[:d].T, "bias": in_b[:d]},
        "k_proj": {"kernel": in_w[d : 2 * d].T, "bias": in_b[d : 2 * d]},
        "v_proj": {"kernel": in_w[2 * d :].T, "bias": in_b[2 * d :]},
        "out_proj": _lin(sd, f"{hp}.attention.out_proj"),
        "norm": _ln(sd, f"{hp}.layernorm"),
        "mlp": {"fc1": _lin(sd, f"{hp}.mlp.fc1"), "fc2": _lin(sd, f"{hp}.mlp.fc2")},
    }
    return params


# --- open_clip timm-backed tower (BiomedCLIP) ----------------------------------------
def open_clip_timm_tower_to_flax(sd: Mapping[str, Any], spec, prefix: str = "visual.trunk.") -> dict:
    """open_clip models whose visual tower is a timm ViT (e.g. BiomedCLIP):
    `visual.trunk.*` timm naming + `visual.head.proj` projection."""
    trunk = {
        k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)
    }
    params = timm_vit_to_flax(trunk, spec)
    if "visual.head.proj.weight" in sd:
        params["proj"] = {"kernel": _np(sd["visual.head.proj.weight"]).T}
    return params


# --- torchvision VisionTransformer ---------------------------------------------------
def torchvision_vit_to_flax(sd: Mapping[str, Any], spec) -> dict:
    """torchvision ``VisionTransformer`` state_dict → the unified ViT param tree."""
    params: dict[str, Any] = {
        "patch_embed": _patch_conv(sd, "conv_proj"),
        "cls_token": _np(sd["class_token"]),
        "pos_embed": _np(sd["encoder.pos_embedding"]),
        "norm": _ln(sd, "encoder.ln"),
    }
    for i in range(spec.depth):
        p = f"encoder.layers.encoder_layer_{i}"
        params[f"blocks_{i}"] = {
            "norm1": _ln(sd, f"{p}.ln_1"),
            "norm2": _ln(sd, f"{p}.ln_2"),
            "attn": {
                "qkv": _qkv_from_packed(
                    sd, f"{p}.self_attention.in_proj_weight", f"{p}.self_attention.in_proj_bias"
                ),
                "proj": _lin(sd, f"{p}.self_attention.out_proj"),
            },
            "mlp": {"fc1": _lin(sd, f"{p}.mlp.0"), "fc2": _lin(sd, f"{p}.mlp.3")},
        }
    return params


# --- the same sources onto this package's ViT state_dict -----------------------------
def _to_torch(to_flax: Callable[..., dict]) -> Callable[..., dict[str, torch.Tensor]]:
    def convert(sd: Mapping[str, Any], spec, **kwargs) -> dict[str, torch.Tensor]:
        return flax_vit_to_torch(to_flax(sd, spec, **kwargs))

    convert.__name__ = convert.__qualname__ = to_flax.__name__.replace("_to_flax", "_to_torch")
    convert.__doc__ = f"``{to_flax.__name__}``, then ``vit.flax_vit_to_torch``: this package's ViT state_dict."
    return convert


timm_vit_to_torch = _to_torch(timm_vit_to_flax)
hf_vit_to_torch = _to_torch(hf_vit_to_flax)
hf_dinov2_to_torch = _to_torch(hf_dinov2_to_flax)
hf_dinov3_to_torch = _to_torch(hf_dinov3_to_flax)
open_clip_vit_to_torch = _to_torch(open_clip_vit_to_flax)
hf_clip_to_torch = _to_torch(hf_clip_to_flax)
hf_siglip_to_torch = _to_torch(hf_siglip_to_flax)
open_clip_timm_tower_to_torch = _to_torch(open_clip_timm_tower_to_flax)
torchvision_vit_to_torch = _to_torch(torchvision_vit_to_flax)
