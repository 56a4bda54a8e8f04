"""Checkpoint conversion for the encoder zoo's ViT-family sources.

The port of ``atlaspatch_tpu/models/encoders/convert.py``, so far for
torchvision's VisionTransformer: the source state_dict is mapped onto the
JAX package's unified ViT param tree (the same function, the same tree), and
that tree onto this package's state_dict by ``vit.flax_vit_to_torch``. The
other sources' converters (timm, transformers, open_clip) wait for ROADMAP
queue 1, item 7.
"""

from __future__ import annotations

from typing import Any, Mapping

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


def _qkv_from_packed(sd, weight_key, bias_key):
    out = {"kernel": _np(sd[weight_key]).T}
    if bias_key in sd:
        out["bias"] = _np(sd[bias_key])
    return out


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


def torchvision_vit_to_torch(sd: Mapping[str, Any], spec) -> dict[str, torch.Tensor]:
    """torchvision ``VisionTransformer`` state_dict → this package's ViT state_dict."""
    return flax_vit_to_torch(torchvision_vit_to_flax(sd, spec))
