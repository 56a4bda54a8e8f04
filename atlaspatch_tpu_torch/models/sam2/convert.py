"""Weights for the port's SAM2ImageModel, in the transformers ``Sam2Model`` layout.

Three sources load into the same ``state_dict`` naming:
  * a transformers ``Sam2Model`` state dict — the port's own layout;
  * the original ``sam2`` package naming, which is what the reference
    pipeline's finetuned checkpoint ``model.pth`` uses (reference:
    atlas_patch/services/segmentation.py:60-68) — translated key by key;
  * the JAX package's parameter tree (numpy arrays, e.g. the ``.npz`` archive
    written by its ``tools/convert_weights.py``), through ``flax_to_torch``,
    the exact inverse of the JAX package's ``hf_to_flax``.

Array layout changes from the Flax tree: Dense (in,out)→(out,in); Conv
(kh,kw,I,O)→(O,I,kh,kw); ConvTranspose (kh,kw,I,O), spatially flipped
(lax.conv_transpose convention)→ un-flipped (I,O,kh,kw); trunk positional
embeddings NHWC→NCHW.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

# Parameters the box-prompt path never reads; absent from the Flax tree.
_OPTIONAL_PREFIXES = ("prompt_encoder.mask_embed.",)
# One buffer registered under two names (tied), as in transformers' Sam2Model.
_TIED_PE = (
    "prompt_encoder.shared_embedding.positional_embedding",
    "shared_image_embedding.positional_embedding",
)


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"], np.float32).T)
    out[f"{prefix}.bias"] = _t(p["bias"])


def _conv(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1))
    out[f"{prefix}.bias"] = _t(p["bias"])


def _conv_transpose(out: dict, prefix: str, p: Mapping) -> None:
    kernel = np.asarray(p["kernel"], np.float32)[::-1, ::-1]  # un-flip (kh, kw, I, O)
    out[f"{prefix}.weight"] = _t(kernel.transpose(2, 3, 0, 1))  # (I, O, kh, kw)
    out[f"{prefix}.bias"] = _t(p["bias"])


def _norm(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _feedforward(out: dict, prefix: str, p: Mapping, num_layers: int) -> None:
    _linear(out, f"{prefix}.proj_in", p["proj_in"])
    _linear(out, f"{prefix}.proj_out", p["proj_out"])
    for i in range(num_layers - 2):
        _linear(out, f"{prefix}.layers.{i}", p[f"layers_{i}"])


def _decoder_attention(out: dict, prefix: str, p: Mapping) -> None:
    for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
        _linear(out, f"{prefix}.{name}", p[name])


def flax_to_torch(params: Mapping[str, Any], cfg) -> dict[str, torch.Tensor]:
    """The JAX package's SAM2ImageModel param tree (numpy or array leaves) →
    float32 state dict for the port's SAM2ImageModel. Inverse of hf_to_flax."""
    out: dict[str, torch.Tensor] = {}
    bb = params["backbone"]
    pre = "vision_encoder.backbone"
    _conv(out, f"{pre}.patch_embed.projection", bb["patch_embed"])
    out[f"{pre}.pos_embed"] = _t(np.asarray(bb["pos_embed"], np.float32).transpose(0, 3, 1, 2))
    out[f"{pre}.pos_embed_window"] = _t(
        np.asarray(bb["pos_embed_window"], np.float32).transpose(0, 3, 1, 2)
    )
    for i in range(sum(cfg.blocks_per_stage)):
        block = bb[f"blocks_{i}"]
        p = f"{pre}.blocks.{i}"
        _norm(out, f"{p}.layer_norm1", block["layer_norm1"])
        _norm(out, f"{p}.layer_norm2", block["layer_norm2"])
        _linear(out, f"{p}.attn.qkv", block["attn"]["qkv"])
        _linear(out, f"{p}.attn.proj", block["attn"]["proj"])
        _feedforward(out, f"{p}.mlp", block["mlp"], 2)
        if "proj" in block:
            _linear(out, f"{p}.proj", block["proj"])

    for i in range(len(cfg.backbone_channel_list)):
        _conv(out, f"vision_encoder.neck.convs.{i}", params["neck"][f"convs_{i}"])

    pe = params["prompt_encoder"]
    gaussian = _t(pe["shared_embedding"]["positional_embedding"])
    for key in _TIED_PE:
        out[key] = gaussian
    out["prompt_encoder.point_embed.weight"] = _t(pe["point_embed"])
    out["prompt_encoder.not_a_point_embed.weight"] = _t(pe["not_a_point_embed"])
    out["prompt_encoder.no_mask_embed.weight"] = _t(pe["no_mask_embed"])

    md = params["mask_decoder"]
    tr = md["transformer"]
    for i in range(cfg.decoder_num_layers):
        p = f"mask_decoder.transformer.layers.{i}"
        layer = tr[f"layers_{i}"]
        for name in ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token"):
            _decoder_attention(out, f"{p}.{name}", layer[name])
        _feedforward(out, f"{p}.mlp", layer["mlp"], 2)  # block MLP is always lin1/lin2
        for n in range(1, 5):
            _norm(out, f"{p}.layer_norm{n}", layer[f"layer_norm{n}"])
    _decoder_attention(
        out, "mask_decoder.transformer.final_attn_token_to_image", tr["final_attn_token_to_image"]
    )
    _norm(out, "mask_decoder.transformer.layer_norm_final_attn", tr["layer_norm_final_attn"])

    for name in ("obj_score_token", "iou_token", "mask_tokens"):
        out[f"mask_decoder.{name}.weight"] = _t(md[name])
    _conv_transpose(out, "mask_decoder.upscale_conv1", md["upscale_conv1"])
    _conv_transpose(out, "mask_decoder.upscale_conv2", md["upscale_conv2"])
    _norm(out, "mask_decoder.upscale_layer_norm", md["upscale_layer_norm"])
    _feedforward(
        out, "mask_decoder.iou_prediction_head", md["iou_prediction_head"], cfg.iou_head_depth
    )
    _feedforward(out, "mask_decoder.pred_obj_score_head", md["pred_obj_score_head"], 3)
    for i in range(cfg.num_multimask_outputs + 1):
        _feedforward(
            out,
            f"mask_decoder.output_hypernetworks_mlps.{i}",
            md[f"output_hypernetworks_mlps_{i}"],
            3,
        )
    _conv(out, "mask_decoder.conv_s0", params["conv_s0"])
    _conv(out, "mask_decoder.conv_s1", params["conv_s1"])
    out["no_memory_embedding"] = _t(params["no_memory_embedding"])
    return out


# --- the other way: a transformers-layout state dict → the JAX param tree ----------
def _np(t: Any) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _flax_linear(sd, prefix):
    return {"kernel": _np(sd[f"{prefix}.weight"]).T, "bias": _np(sd[f"{prefix}.bias"])}


def _flax_conv(sd, prefix):
    return {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0), "bias": _np(sd[f"{prefix}.bias"])}


def _flax_conv_transpose(sd, prefix):
    w = _np(sd[f"{prefix}.weight"])  # (I, O, kh, kw)
    kernel = w.transpose(2, 3, 0, 1)[::-1, ::-1]  # (kh, kw, I, O), flipped
    return {"kernel": np.ascontiguousarray(kernel), "bias": _np(sd[f"{prefix}.bias"])}


def _flax_norm(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _flax_feedforward(sd, prefix, num_layers):
    out = {
        "proj_in": _flax_linear(sd, f"{prefix}.proj_in"),
        "proj_out": _flax_linear(sd, f"{prefix}.proj_out"),
    }
    for i in range(num_layers - 2):
        out[f"layers_{i}"] = _flax_linear(sd, f"{prefix}.layers.{i}")
    return out


def _flax_decoder_attention(sd, prefix):
    return {name: _flax_linear(sd, f"{prefix}.{name}") for name in ("q_proj", "k_proj", "v_proj", "o_proj")}


def hf_to_flax(sd: Mapping[str, Any], cfg) -> dict:
    """A transformers ``Sam2Model`` state dict (the port's own layout) → the
    JAX package's SAM2ImageModel param tree: the JAX ``hf_to_flax``'s copy,
    for ``tools/convert_weights.py``'s archives. :func:`flax_to_torch` is
    its inverse."""
    backbone: dict[str, Any] = {
        "patch_embed": _flax_conv(sd, "vision_encoder.backbone.patch_embed.projection"),
        "pos_embed": _np(sd["vision_encoder.backbone.pos_embed"]).transpose(0, 2, 3, 1),
        "pos_embed_window": _np(sd["vision_encoder.backbone.pos_embed_window"]).transpose(0, 2, 3, 1),
    }
    for i in range(sum(cfg.blocks_per_stage)):
        p = f"vision_encoder.backbone.blocks.{i}"
        block = {
            "layer_norm1": _flax_norm(sd, f"{p}.layer_norm1"),
            "layer_norm2": _flax_norm(sd, f"{p}.layer_norm2"),
            "attn": {
                "qkv": _flax_linear(sd, f"{p}.attn.qkv"),
                "proj": _flax_linear(sd, f"{p}.attn.proj"),
            },
            "mlp": _flax_feedforward(sd, f"{p}.mlp", 2),
        }
        if f"{p}.proj.weight" in sd:
            block["proj"] = _flax_linear(sd, f"{p}.proj")
        backbone[f"blocks_{i}"] = block

    neck = {
        f"convs_{i}": _flax_conv(sd, f"vision_encoder.neck.convs.{i}")
        for i in range(len(cfg.backbone_channel_list))
    }
    prompt_encoder = {
        "shared_embedding": {
            "positional_embedding": _np(sd.get(_TIED_PE[0], sd.get(_TIED_PE[1])))
        },
        "point_embed": _np(sd["prompt_encoder.point_embed.weight"]),
        "not_a_point_embed": _np(sd["prompt_encoder.not_a_point_embed.weight"]),
        "no_mask_embed": _np(sd["prompt_encoder.no_mask_embed.weight"]),
    }
    transformer: dict[str, Any] = {}
    for i in range(cfg.decoder_num_layers):
        p = f"mask_decoder.transformer.layers.{i}"
        transformer[f"layers_{i}"] = {
            "self_attn": _flax_decoder_attention(sd, f"{p}.self_attn"),
            "cross_attn_token_to_image": _flax_decoder_attention(sd, f"{p}.cross_attn_token_to_image"),
            "cross_attn_image_to_token": _flax_decoder_attention(sd, f"{p}.cross_attn_image_to_token"),
            "mlp": _flax_feedforward(sd, f"{p}.mlp", 2),  # block MLP is always lin1/lin2
            **{f"layer_norm{n}": _flax_norm(sd, f"{p}.layer_norm{n}") for n in range(1, 5)},
        }
    transformer["final_attn_token_to_image"] = _flax_decoder_attention(
        sd, "mask_decoder.transformer.final_attn_token_to_image")
    transformer["layer_norm_final_attn"] = _flax_norm(sd, "mask_decoder.transformer.layer_norm_final_attn")

    mask_decoder: dict[str, Any] = {
        "obj_score_token": _np(sd["mask_decoder.obj_score_token.weight"]),
        "iou_token": _np(sd["mask_decoder.iou_token.weight"]),
        "mask_tokens": _np(sd["mask_decoder.mask_tokens.weight"]),
        "transformer": transformer,
        "upscale_conv1": _flax_conv_transpose(sd, "mask_decoder.upscale_conv1"),
        "upscale_conv2": _flax_conv_transpose(sd, "mask_decoder.upscale_conv2"),
        "upscale_layer_norm": _flax_norm(sd, "mask_decoder.upscale_layer_norm"),
        "iou_prediction_head": _flax_feedforward(sd, "mask_decoder.iou_prediction_head", cfg.iou_head_depth),
        "pred_obj_score_head": _flax_feedforward(sd, "mask_decoder.pred_obj_score_head", 3),
    }
    for i in range(cfg.num_multimask_outputs + 1):
        mask_decoder[f"output_hypernetworks_mlps_{i}"] = _flax_feedforward(
            sd, f"mask_decoder.output_hypernetworks_mlps.{i}", 3)
    return {
        "backbone": backbone,
        "neck": neck,
        "prompt_encoder": prompt_encoder,
        "mask_decoder": mask_decoder,
        "conv_s0": _flax_conv(sd, "mask_decoder.conv_s0"),
        "conv_s1": _flax_conv(sd, "mask_decoder.conv_s1"),
        "no_memory_embedding": _np(sd["no_memory_embedding"]),
    }


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested tree → '/'-joined keys, as the JAX package's
    ``tools/convert_weights.py::_flatten`` writes its ``.npz`` archives."""
    out: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def torch_to_flax_flat(model_or_state_dict: Any, cfg) -> dict[str, np.ndarray]:
    """The port's SAM2ImageModel (or its state dict) → the JAX package's
    parameter tree as '/'-joined float32 numpy arrays: the keys, shapes and
    layouts of the JAX ``.npz`` archives, which both packages'
    ``--sam2-checkpoint`` load. Inverse of :func:`flax_to_torch`."""
    sd = model_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    return {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in flatten(hf_to_flax(sd, cfg)).items()}


def flax_key_map(model: torch.nn.Module) -> dict[str, str]:
    """{state-dict key of ``model``: the '/'-joined key of the JAX parameter
    it converts to}, read off ``hf_to_flax`` itself: every tensor is stood in
    for by a constant view of its shape holding its index, and each Flax leaf
    names the index it came from. Keys with no JAX parameter (the mask prompt
    encoder, the second name of the tied Fourier projection) are left out."""
    sd = model.state_dict()
    keys = list(sd)
    stand_in = {k: np.broadcast_to(np.float32(i), tuple(sd[k].shape)) for i, k in enumerate(keys)}
    return {keys[int(leaf.flat[0])]: path for path, leaf in flatten(hf_to_flax(stand_in, model.cfg)).items()}


def _zeros_like_state(model: torch.nn.Module) -> dict[str, np.ndarray]:
    return {k: np.broadcast_to(np.float32(0), tuple(t.shape)) for k, t in model.state_dict().items()}


def to_flax_layout(model: torch.nn.Module, tensors: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """{Flax key: tensor shaped like ``model``'s} (a gradient or an optimizer
    moment) → {Flax key: float32 array in the JAX parameter's layout}: the
    tensors ride through ``hf_to_flax`` in their parameters' places."""
    port_of = {flax_key: key for key, flax_key in flax_key_map(model).items()}
    sd: dict[str, Any] = _zeros_like_state(model)
    sd.update({port_of[k]: v for k, v in tensors.items()})
    flat = flatten(hf_to_flax(sd, model.cfg))
    return {k: np.ascontiguousarray(flat[k], np.float32) for k in tensors}


def from_flax_layout(model: torch.nn.Module, arrays: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Inverse of :func:`to_flax_layout`: {Flax key: array in the JAX
    layout} → {Flax key: float32 CPU tensor shaped like ``model``'s}."""
    port_of = {flax_key: key for key, flax_key in flax_key_map(model).items()}
    flat = flatten(hf_to_flax(_zeros_like_state(model), model.cfg))
    flat.update(arrays)
    sd = flax_to_torch(unflatten(flat), model.cfg)
    return {k: sd[port_of[k]] for k in arrays}


def unflatten(flat: Mapping[str, Any]) -> dict:
    """'a/b/c'-keyed arrays (the JAX package's .npz archives) → nested tree."""
    tree: dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_npz(path, cfg) -> dict[str, torch.Tensor]:
    """The JAX package's ``sam2_hiera_tiny.npz`` archive → port state dict."""
    with np.load(path) as archive:
        return flax_to_torch(unflatten(dict(archive)), cfg)


# --- original `sam2` package key scheme --------------------------------------------
def _original_to_hf_key(key: str) -> str | None:
    """Translate an original-sam2 state-dict key to the HF scheme; None = skip
    (video-only modules the image path never uses)."""
    drop_prefixes = (
        "memory_attention.",
        "memory_encoder.",
        "mask_downsample.",
        "obj_ptr_proj.",
        "obj_ptr_tpos_proj.",
    )
    drop_exact = {
        "no_mem_pos_enc",
        "no_obj_ptr",
        "no_obj_embed_spatial",
        "maskmem_tpos_enc",
    }
    if key in drop_exact or any(key.startswith(p) for p in drop_prefixes):
        return None

    k = key
    k = k.replace("image_encoder.trunk.", "vision_encoder.backbone.")
    k = k.replace("image_encoder.neck.", "vision_encoder.neck.")
    k = k.replace("patch_embed.proj.", "patch_embed.projection.")
    # neck convs: original wraps conv in a submodule
    k = k.replace(".conv.weight", ".weight").replace(".conv.bias", ".bias")
    # trunk block norms
    k = k.replace(".norm1.", ".layer_norm1.").replace(".norm2.", ".layer_norm2.")
    # trunk MLP: original MLP uses layers.0 / layers.1
    if "vision_encoder.backbone.blocks." in k and ".mlp.layers." in k:
        k = k.replace(".mlp.layers.0.", ".mlp.proj_in.")
        k = k.replace(".mlp.layers.1.", ".mlp.proj_out.")

    k = k.replace("sam_prompt_encoder.", "prompt_encoder.")
    k = k.replace(
        "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
        "prompt_encoder.shared_embedding.positional_embedding",
    )
    if "prompt_encoder.point_embeddings." in k:
        # original: 4 separate Embedding(1, C); HF: one Embedding(4, C). Handled
        # specially in original_to_hf; mark with a sentinel passthrough.
        return key
    k = k.replace("prompt_encoder.mask_downscaling.", "prompt_encoder.mask_embed.")

    k = k.replace("sam_mask_decoder.", "mask_decoder.")
    # two-way transformer norms + out_proj
    if "mask_decoder.transformer." in k:
        k = k.replace(".norm1.", ".layer_norm1.").replace(".norm2.", ".layer_norm2.")
        k = k.replace(".norm3.", ".layer_norm3.").replace(".norm4.", ".layer_norm4.")
        k = k.replace("transformer.norm_final_attn.", "transformer.layer_norm_final_attn.")
        k = k.replace(".out_proj.", ".o_proj.")
        # MLPBlock lin1/lin2 → proj_in/proj_out
        k = k.replace(".mlp.lin1.", ".mlp.proj_in.").replace(".mlp.lin2.", ".mlp.proj_out.")
    # output upscaling Sequential: 0=convT,1=LN,3=convT
    k = k.replace("mask_decoder.output_upscaling.0.", "mask_decoder.upscale_conv1.")
    k = k.replace("mask_decoder.output_upscaling.1.", "mask_decoder.upscale_layer_norm.")
    k = k.replace("mask_decoder.output_upscaling.3.", "mask_decoder.upscale_conv2.")
    # 3-layer MLP heads: layers.{0,1,2} → proj_in / layers.0 / proj_out
    for head in (
        "output_hypernetworks_mlps.0",
        "output_hypernetworks_mlps.1",
        "output_hypernetworks_mlps.2",
        "output_hypernetworks_mlps.3",
        "iou_prediction_head",
        "pred_obj_score_head",
    ):
        base = f"mask_decoder.{head}.layers."
        if base + "0." in k:
            k = k.replace(base + "0.", f"mask_decoder.{head}.proj_in.")
        elif base + "2." in k:
            k = k.replace(base + "2.", f"mask_decoder.{head}.proj_out.")
        elif base + "1." in k:
            k = k.replace(base + "1.", f"mask_decoder.{head}.layers.0.")

    if k == "no_mem_embed":
        return "no_memory_embedding"
    return k


def original_to_hf(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Original sam2-package state dict (the reference checkpoint format) →
    transformers-layout state dict."""
    hf_sd: dict[str, Any] = {}
    point_rows: dict[int, torch.Tensor] = {}
    for key, value in sd.items():
        mapped = _original_to_hf_key(key)
        if mapped is None:
            continue
        if "prompt_encoder.point_embeddings." in mapped:
            idx = int(mapped.split("point_embeddings.")[1].split(".")[0])
            point_rows[idx] = torch.as_tensor(value).reshape(-1)
            continue
        hf_sd[mapped] = value
    if point_rows:
        hf_sd["prompt_encoder.point_embed.weight"] = torch.stack(
            [point_rows[i] for i in sorted(point_rows)], dim=0
        )
    return hf_sd


def load_checkpoint(path: str) -> dict[str, Any]:
    """Load a torch .pth/.pt checkpoint (original or HF naming) as a
    transformers-layout state dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    keys = list(ckpt.keys())
    if any(k.startswith("image_encoder.trunk") for k in keys):
        return original_to_hf(ckpt)
    if any(k.startswith("sam2.") for k in keys):
        ckpt = {k[len("sam2.") :]: v for k, v in ckpt.items()}
    return ckpt


def load_into(model: torch.nn.Module, sd: Mapping[str, Any]) -> None:
    """Load a converted state dict into ``model``.

    Keys the model does not have are ignored (video-only modules), as the JAX
    converter ignores them. Every model key must be present except the mask
    prompt encoder, which the box-prompt path never reads; one of the two
    names of the tied Fourier projection suffices."""
    sd = dict(sd)
    for a, b in (_TIED_PE, _TIED_PE[::-1]):
        if a not in sd and b in sd:
            sd[a] = sd[b]
    own = model.state_dict()
    missing = [k for k in own if k not in sd and not k.startswith(_OPTIONAL_PREFIXES)]
    if missing:
        raise KeyError(f"SAM2 state dict lacks {len(missing)} keys, e.g. {missing[:5]}")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items() if k in own}, strict=False)
