"""The encoder zoo: all 66 reference extractor names, registered lazily.

The port of ``atlaspatch_tpu/models/encoders/zoo.py``. Every name the
reference registers (reference: atlas_patch/models/patch/__init__.py:47-80)
is here with its exact embedding dim and preprocessing, equal to the JAX
package's table. The 45 ViT-family names build on the unified ViT
(models/encoders/vit.py), the 8 ResNet names (torchvision's five and Lunit's
three) on models/encoders/resnet.py, the 4 ConvNeXt names on
models/encoders/convnext.py, the 5 CLIP ModifiedResNets on clip_resnet.py,
conch_v1 and omiclip on coca.py, musk on beit3.py (its multi-scale forward)
and chief-ctranspath on swin.py.

Weights policy: create() builds the model on its device and loads real
weights when present (ATLASPATCH_WEIGHTS_DIR or the HF hub cache): ``.npz``
archives of the JAX param tree, or source checkpoints (``.safetensors``,
read by the port's own reader, or torch ``.pt`` / ``.pth`` / ``.bin``)
through the per-source converters; when absent it raises unless
ATLASPATCH_ALLOW_RANDOM_WEIGHTS=1, which deterministically random-inits the
model (throughput benchmarking and smoke tests).

Devices: "cuda" (the default) or "cpu". A CUDA request without a card raises;
there is no fallback to the CPU.
"""

from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any

import numpy as np

from atlaspatch_tpu_torch.models.encoders import convert as C
from atlaspatch_tpu_torch.models.encoders.beit3 import (
    Beit3Spec,
    MuskMsAug,
    flax_beit3_to_torch,
    musk_beit3_to_flax,
)
from atlaspatch_tpu_torch.models.encoders.clip_resnet import (
    CLIP_RESNET_SPECS,
    ClipModifiedResNet,
    flax_clip_resnet_to_torch,
    open_clip_resnet_to_flax,
)
from atlaspatch_tpu_torch.models.encoders.coca import (
    CoCaVisual,
    coca_vit_l14_spec,
    conch_v1_spec,
    conch_v1_to_flax,
    flax_coca_to_torch,
    open_clip_coca_to_flax,
)
from atlaspatch_tpu_torch.models.encoders.engine import (
    PreprocessSpec,
    TorchFeatureExtractor,
    init_random_weights_,
    require_device,
)
from atlaspatch_tpu_torch.models.encoders.convnext import (
    CONVNEXT_SPECS,
    ConvNeXt,
    flax_convnext_to_torch,
    torchvision_convnext_to_flax,
    torchvision_convnext_to_torch,
)
from atlaspatch_tpu_torch.models.encoders.registry import PatchFeatureExtractorRegistry
from atlaspatch_tpu_torch.models.encoders.resnet import (
    RESNET_SPECS,
    ResNet,
    flax_resnet_to_torch,
    torchvision_resnet_to_flax,
    torchvision_resnet_to_torch,
)
from atlaspatch_tpu_torch.models.encoders.swin import (
    SwinNet,
    SwinSpec,
    flax_swin_to_torch,
    hf_swin_to_flax,
    timm_swin_to_flax,
)
from atlaspatch_tpu_torch.models.encoders.vit import ViT, ViTSpec, flax_tree_to_torch, quantize_vit_state_dict
from atlaspatch_tpu_torch.utils import safetensors

logger = logging.getLogger("atlaspatch_tpu_torch.models.encoders.zoo")

IMAGENET = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
OPENAI_CLIP = dict(
    mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)
)
HALF = dict(mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
HOPTIMUS_NORM = dict(mean=(0.707223, 0.578729, 0.703617), std=(0.211883, 0.230117, 0.177517))
HIBOU_NORM = dict(mean=(0.7068, 0.5755, 0.722), std=(0.195, 0.2316, 0.1816))


@dataclass(frozen=True)
class EncoderEntry:
    name: str
    family: str  # vit | dinov2 | clip_hf | clip_openclip | siglip | resnet | convnext | timm_vit | torchvision_vit | swin | coca | conch | beit3 | clip_modified_resnet
    embedding_dim: int
    preprocess: PreprocessSpec
    spec: Any = None
    source: str = ""  # upstream weight source (documentation / cache lookup)
    implemented: bool = True
    notes: str = ""


def _vit(
    img,
    patch,
    dim,
    depth,
    heads,
    *,
    mlp_hidden=None,
    mlp_ratio=4.0,
    **kw,
) -> ViTSpec:
    return ViTSpec(
        img_size=img,
        patch_size=patch,
        dim=dim,
        depth=depth,
        heads=heads,
        mlp_hidden=mlp_hidden,
        mlp_ratio=mlp_ratio,
        **kw,
    )


def _pre(crop, *, mode="shortest", resize=None, interp="bilinear", norm=IMAGENET):
    return PreprocessSpec(
        crop=crop,
        resize=resize if resize is not None else crop,
        mode=mode,
        interpolation=interp,
        mean=norm["mean"],
        std=norm["std"],
    )


def _dinov2_spec(img, dim, depth, heads, *, swiglu=False, reg=0, pool="cls"):
    hidden = (int(dim * 4 * 2 / 3) + 7) // 8 * 8 if swiglu else dim * 4
    return _vit(
        img,
        14,
        dim,
        depth,
        heads,
        mlp_hidden=hidden,
        layerscale=True,
        swiglu=swiglu,
        act="silu" if swiglu else "gelu",
        reg_tokens=reg,
        ln_eps=1e-6,
        pool=pool,
    )


def _timm_giant(img=224, patch=14, *, reg=4, pool="cls"):
    # DINOv2-style ViT-g: dim 1536, depth 40, heads 24, SwiGLU gate 4096
    return _vit(
        img,
        patch,
        1536,
        40,
        24,
        mlp_hidden=4096,
        layerscale=True,
        swiglu=True,
        act="silu",
        reg_tokens=reg,
        pos_mode="patches" if reg else "prefix",
        ln_eps=1e-6,
        pool=pool,
    )


def _clip_tower(img, patch, dim, depth, heads, proj):
    return _vit(
        img,
        patch,
        dim,
        depth,
        heads,
        act="quick_gelu",
        pre_ln=True,
        patch_bias=False,
        proj_dim=proj,
        ln_eps=1e-5,
        pool="cls",
    )


def build_entries() -> list[EncoderEntry]:
    e: list[EncoderEntry] = []

    # --- torchvision CNNs / ViTs (reference: resnet.py, convnext.py, vit.py) -------
    for name, spec in RESNET_SPECS.items():
        e.append(
            EncoderEntry(
                name,
                "resnet",
                spec.embedding_dim,
                _pre(224, resize=256),
                spec=spec,
                source=f"torchvision {name} IMAGENET1K_V1",
            )
        )
    tv_resize = {"convnext_tiny": 236, "convnext_small": 230, "convnext_base": 232, "convnext_large": 232}
    for name, spec in CONVNEXT_SPECS.items():
        e.append(
            EncoderEntry(
                name,
                "convnext",
                spec.embedding_dim,
                _pre(224, resize=tv_resize[name]),
                spec=spec,
                source=f"torchvision {name} IMAGENET1K_V1",
            )
        )
    tv_vits = {
        "vit_b_16": (_vit(224, 16, 768, 12, 12, ln_eps=1e-6), 768, _pre(224, resize=256)),
        "vit_b_32": (_vit(224, 32, 768, 12, 12, ln_eps=1e-6), 768, _pre(224, resize=256)),
        "vit_l_16": (_vit(224, 16, 1024, 24, 16, ln_eps=1e-6), 1024, _pre(224, resize=242)),
        "vit_l_32": (_vit(224, 32, 1024, 24, 16, ln_eps=1e-6), 1024, _pre(224, resize=256)),
        "vit_h_14": (
            _vit(518, 14, 1280, 32, 16, ln_eps=1e-6),
            1280,
            _pre(518, resize=518, interp="bicubic"),
        ),
    }
    for name, (spec, dim, pre) in tv_vits.items():
        e.append(
            EncoderEntry(name, "torchvision_vit", dim, pre, spec=spec, source=f"torchvision {name}")
        )

    # --- DINOv2 (reference: dinov2.py; CLS of last_hidden_state) -------------------
    for name, dim, depth, heads, swiglu in (
        ("dinov2_small", 384, 12, 6, False),
        ("dinov2_base", 768, 12, 12, False),
        ("dinov2_large", 1024, 24, 16, False),
        ("dinov2_giant", 1536, 40, 24, True),
    ):
        e.append(
            EncoderEntry(
                name,
                "dinov2",
                dim,
                _pre(224, resize=256, interp="bicubic"),
                spec=_dinov2_spec(224, dim, depth, heads, swiglu=swiglu),
                source=f"facebook/{name.replace('_', '-')}",
            )
        )

    # --- DINOv3 (reference: dinov3.py; pooler output = CLS). Axial-RoPE ViT --------
    def _dinov3_spec(dim, depth, heads, mlp, gated):
        return _vit(
            224,
            16,
            dim,
            depth,
            heads,
            mlp_hidden=mlp,
            layerscale=True,
            gated_mlp=gated,
            reg_tokens=4,
            class_token=True,
            pos_mode="rope",
            ln_eps=1e-5,
            pool="cls",
        )

    dinov3_variants = {
        # Configs from the public facebook/dinov3-* HF cards / DINOv3 paper.
        # Validated two ways without network: each variant's total param count
        # matches the published size (tests/test_zoo_param_counts.py: 21.6M/
        # 29M/86M/303M/840M/6716M), and the converter↔model layout is checked
        # at these dims by tests/test_converter_harness.py. The 'plus' and 7B
        # variants use the gated SwiGLU FFN; all use axial RoPE + 4 registers.
        "dinov3_vits16": (_dinov3_spec(384, 12, 6, 1536, False), 384, ""),
        "dinov3_vits16_plus": (_dinov3_spec(384, 12, 6, 1536, True), 384, ""),
        "dinov3_vitb16": (_dinov3_spec(768, 12, 12, 3072, False), 768, ""),
        "dinov3_vitl16": (_dinov3_spec(1024, 24, 16, 4096, False), 1024, ""),
        "dinov3_vitl16_sat": (_dinov3_spec(1024, 24, 16, 4096, False), 1024, "-sat493m"),
        "dinov3_vith16_plus": (_dinov3_spec(1280, 32, 20, 5120, True), 1280, ""),
        "dinov3_vit7b16": (_dinov3_spec(4096, 40, 32, 8192, True), 4096, ""),
        "dinov3_vit7b16_sat": (_dinov3_spec(4096, 40, 32, 8192, True), 4096, "-sat493m"),
    }
    for name, (spec, dim, suffix) in dinov3_variants.items():
        hub = name.replace("dinov3_", "dinov3-").replace("_plus", "plus").replace("_sat", "")
        e.append(
            EncoderEntry(
                name,
                "dinov3",
                dim,
                _pre(224, mode="square"),
                spec=spec,
                source=f"facebook/{hub}-pretrain-lvd1689m{suffix or ''}".replace(
                    "-pretrain-lvd1689m-sat493m", "-pretrain-sat493m"
                ),
            )
        )

    # --- OpenAI CLIP (reference: clip.py; encode_image) ----------------------------
    clip_vits = {
        "clip_vit_b_32": (_clip_tower(224, 32, 768, 12, 12, 512), 512, 224),
        "clip_vit_b_16": (_clip_tower(224, 16, 768, 12, 12, 512), 512, 224),
        "clip_vit_l_14": (_clip_tower(224, 14, 1024, 24, 16, 768), 768, 224),
        "clip_vit_l_14_336": (_clip_tower(336, 14, 1024, 24, 16, 768), 768, 336),
    }
    for name, (spec, dim, size) in clip_vits.items():
        e.append(
            EncoderEntry(
                name,
                "clip_openclip",
                dim,
                _pre(size, resize=size, interp="bicubic", norm=OPENAI_CLIP),
                spec=spec,
                source=f"open_clip openai {name}",
            )
        )
    for name, spec in CLIP_RESNET_SPECS.items():
        e.append(
            EncoderEntry(
                name,
                "clip_modified_resnet",
                spec.embed_dim,
                _pre(spec.image_size, resize=spec.image_size, interp="bicubic", norm=OPENAI_CLIP),
                spec=spec,
                source=f"open_clip openai {name}",
            )
        )

    # --- CONCH / OmiCLIP / Quilt / PLIP / BiomedCLIP / MedSigLIP -------------------
    e.append(
        EncoderEntry(
            "conch_v1",
            "conch",
            512,
            _pre(224, interp="bicubic", norm=OPENAI_CLIP),
            spec=conch_v1_spec(),
            source="MahmoodLab/conch conch_ViT-B-16",
            notes="encode_image(proj_contrast=False, normalize=False) semantics "
            "(reference conch.py:20-65); checkpoint naming verified at load",
        )
    )
    e.append(
        EncoderEntry(
            "conch_v15",
            "timm_vit",
            768,
            _pre(448, mode="square", interp="bicubic", norm=OPENAI_CLIP),
            spec=_vit(448, 16, 1024, 24, 16, ln_eps=1e-5, proj_dim=768),
            source="MahmoodLab/TITAN conch_v1_5",
            notes="ViT-L/16 @448 with 768-d projection (reference conch.py:68-113); "
            "checkpoint naming verified at load",
        )
    )
    e.append(
        EncoderEntry(
            "omiclip",
            "coca",
            768,
            _pre(224, interp="bicubic", norm=OPENAI_CLIP),
            spec=coca_vit_l14_spec(),
            source="WangGuangyuLab/Loki coca_ViT-L-14",
            notes="token-0 latent of the attentional pooler (open_clip CoCa)",
        )
    )
    for name in ("quilt_b_32", "quilt_b_16"):
        patch = 32 if name.endswith("32") else 16
        e.append(
            EncoderEntry(
                name,
                "clip_hf",
                512,
                _pre(224, resize=224, interp="bicubic", norm=OPENAI_CLIP),
                spec=_clip_tower(224, patch, 768, 12, 12, 512),
                source=f"wisdomik/QuiltNet-B-{patch}",
            )
        )
    e.append(
        EncoderEntry(
            "quilt_b_16_pmb",
            "clip_openclip",
            512,
            _pre(224, resize=224, interp="bicubic", norm=OPENAI_CLIP),
            spec=_clip_tower(224, 16, 768, 12, 12, 512),
            source="wisdomik/QuiltNet-B-16-PMB",
        )
    )
    e.append(
        EncoderEntry(
            "plip",
            "clip_hf",
            512,
            _pre(224, resize=224, interp="bicubic", norm=OPENAI_CLIP),
            spec=_clip_tower(224, 32, 768, 12, 12, 512),
            source="vinid/plip",
        )
    )
    e.append(
        EncoderEntry(
            "biomedclip",
            "clip_timm_tower",
            512,
            _pre(224, resize=224, interp="bicubic", norm=OPENAI_CLIP),
            spec=_vit(224, 16, 768, 12, 12, ln_eps=1e-6, proj_dim=512, pool="cls"),
            source="microsoft/BiomedCLIP-PubMedBERT_256-vit_base_patch16_224",
        )
    )
    e.append(
        EncoderEntry(
            "medsiglip",
            "siglip",
            1152,
            _pre(448, mode="square", norm=HALF),
            spec=_vit(
                448,
                14,
                1152,
                27,
                16,
                mlp_hidden=4304,
                act="gelu_tanh",
                class_token=False,
                pos_mode="patches",
                ln_eps=1e-6,
                pool="map",
            ),
            source="google/medsiglip-448",
        )
    )

    # --- pathology timm ViTs -------------------------------------------------------
    e.append(
        EncoderEntry(
            "uni_v1",
            "timm_vit",
            1024,
            _pre(224, resize=256, interp="bicubic"),
            spec=_vit(224, 16, 1024, 24, 16, layerscale=True, ln_eps=1e-6),
            source="MahmoodLab/uni",
        )
    )
    e.append(
        EncoderEntry(
            "uni_v2",
            "timm_vit",
            1536,
            _pre(224, resize=256, interp="bicubic"),
            spec=_vit(
                224,
                14,
                1536,
                24,
                24,
                mlp_hidden=4096,
                layerscale=True,
                swiglu=True,
                act="silu",
                reg_tokens=8,
                pos_mode="patches",
                ln_eps=1e-6,
            ),
            source="MahmoodLab/UNI2-h",
        )
    )
    for name in ("lunit_resnet50_bt", "lunit_resnet50_swav", "lunit_resnet50_mocov2"):
        e.append(
            EncoderEntry(
                name,
                "resnet",
                2048,
                _pre(224, resize=256),
                spec=RESNET_SPECS["resnet50"],
                source=f"1aurent/resnet50.{name.split('_')[-1]}",
            )
        )
    e.append(
        EncoderEntry(
            "lunit_vit_small_patch16_dino",
            "timm_vit",
            384,
            _pre(224, resize=256, interp="bicubic"),
            spec=_vit(224, 16, 384, 12, 6, ln_eps=1e-6),
            source="1aurent/vit_small_patch16_224.lunit_dino",
        )
    )
    e.append(
        EncoderEntry(
            "lunit_vit_small_patch8_dino",
            "timm_vit",
            384,
            _pre(224, resize=256, interp="bicubic"),
            spec=_vit(224, 8, 384, 12, 6, ln_eps=1e-6),
            source="1aurent/vit_small_patch8_224.lunit_dino",
        )
    )
    e.append(
        EncoderEntry(
            "h_optimus_0",
            "timm_vit",
            1536,
            # Exact Resize((224,224)) torchvision-default bilinear
            # (reference hoptimus.py:15-31)
            _pre(224, mode="square", norm=HOPTIMUS_NORM),
            spec=_timm_giant(),
            source="bioptimus/H-optimus-0",
        )
    )
    e.append(
        EncoderEntry(
            "h_optimus_1",
            "timm_vit",
            1536,
            _pre(224, mode="square", norm=HOPTIMUS_NORM),
            spec=_timm_giant(),
            source="bioptimus/H-optimus-1",
        )
    )
    e.append(
        EncoderEntry(
            "h0_mini",
            "timm_vit",
            1536,
            _pre(224, mode="square", interp="bicubic", norm=HOPTIMUS_NORM),
            spec=_vit(
                224,
                14,
                768,
                12,
                12,
                mlp_hidden=2048,
                layerscale=True,
                swiglu=True,
                act="silu",
                reg_tokens=4,
                pos_mode="patches",
                ln_eps=1e-6,
                pool="cls_mean_concat",
            ),
            source="bioptimus/H0-mini",
            notes="CLS + mean(patch tokens) concat (reference hoptimus.py:157-167)",
        )
    )
    e.append(
        EncoderEntry(
            "virchow_v1",
            "timm_vit",
            2560,
            _pre(224, mode="square", interp="bicubic"),
            spec=_vit(
                224,
                14,
                1280,
                32,
                16,
                mlp_hidden=3416,
                layerscale=True,
                swiglu=True,
                act="silu",
                ln_eps=1e-6,
                pool="cls_mean_concat",
            ),
            source="paige-ai/Virchow",
            notes="CLS + mean(patch tokens) concat (reference virchow.py:57-61)",
        )
    )
    e.append(
        EncoderEntry(
            "virchow_v2",
            "timm_vit",
            2560,
            _pre(224, mode="square", interp="bicubic"),
            spec=_vit(
                224,
                14,
                1280,
                32,
                16,
                mlp_hidden=3416,
                layerscale=True,
                swiglu=True,
                act="silu",
                reg_tokens=4,
                pos_mode="patches",
                ln_eps=1e-6,
                pool="cls_mean_concat",
            ),
            source="paige-ai/Virchow2",
            notes="skips 4 register tokens (reference virchow.py:110-114)",
        )
    )
    e.append(
        EncoderEntry(
            "prov_gigapath",
            "timm_vit",
            1536,
            _pre(224, resize=256, interp="bicubic"),
            spec=_timm_giant(reg=0),
            source="prov-gigapath/prov-gigapath",
            notes="Resize256-BICUBIC + CenterCrop224 (reference gigapath.py:12-60)",
        )
    )
    e.append(
        EncoderEntry(
            "pathorchestra",
            "timm_vit",
            1024,
            # Resize(224) + Normalize only, NO center crop, torchvision
            # default bilinear (reference pathorchestra.py:52-58)
            _pre(224, mode="square"),
            spec=_vit(224, 16, 1024, 24, 16, layerscale=True, ln_eps=1e-6),
            source="AI4Pathology/PathOrchestra",
        )
    )
    e.append(
        EncoderEntry(
            "openmidnight",
            "timm_vit",
            1536,
            # Exact Resize((224,224)) bilinear, no crop (reference
            # openmidnight.py:15-28)
            _pre(224, mode="square"),
            spec=_timm_giant(),
            source="torch.hub dinov2_vitg14_reg + OpenMidnight teacher ckpt",
        )
    )

    # --- transformers pathology models --------------------------------------------
    e.append(
        EncoderEntry(
            "phikon_v1",
            "hf_vit",
            768,
            _pre(224, mode="square"),
            spec=_vit(224, 16, 768, 12, 12, ln_eps=1e-12),
            source="owkin/phikon",
        )
    )
    e.append(
        EncoderEntry(
            "phikon_v2",
            "dinov2",
            1024,
            _pre(224, mode="square"),
            spec=_dinov2_spec(224, 1024, 24, 16),
            source="owkin/phikon-v2",
        )
    )
    for name, dim, depth, heads in (("hibou_b", 768, 12, 12), ("hibou_l", 1024, 24, 16)):
        e.append(
            EncoderEntry(
                name,
                "dinov2",
                dim,
                _pre(224, resize=224, mode="square", norm=HIBOU_NORM),
                spec=_dinov2_spec(224, dim, depth, heads, reg=4),
                source=f"histai/{name.replace('_', '-')}",
            )
        )
    e.append(
        EncoderEntry(
            "midnight",
            "dinov2",
            3072,
            _pre(224, mode="square", norm=HALF),
            spec=_dinov2_spec(224, 1536, 40, 24, swiglu=True, pool="cls_mean_concat"),
            source="kaiko-ai/midnight",
            notes="CLS + mean(patch tokens) concat (reference midnight.py:12-66)",
        )
    )

    # --- remaining special towers --------------------------------------------------
    e.append(
        EncoderEntry(
            "musk",
            "beit3",
            2048,
            # Resize(384) shortest-edge bicubic + CenterCrop(384), Inception
            # norm = (0.5, 0.5, 0.5) (reference musk.py:16-27)
            _pre(384, interp="bicubic", norm=HALF),
            spec=Beit3Spec(),  # BEiT3-large @384, Inception norm (musk.py:12-85)
            source="xiangjx/musk",
            notes="ms_aug multi-scale TTA (scales 1+2): mean CLS per scale, "
            "concatenated → 2048-d as actually stored by the reference "
            "(its declared 1024 is only the empty-batch fallback)",
        )
    )
    e.append(
        EncoderEntry(
            "chief-ctranspath",
            "swin",
            768,
            _pre(224, mode="square"),
            spec=SwinSpec(),  # swin-tiny + CHIEF ConvStem, spatial-mean pooled
            source="CHIEF CTransPath (Swin-tiny + ConvStem)",
            notes="NHWC spatial mean-pool forward (reference chief_ctranspath.py:180-186)",
        )
    )
    return e


ENTRIES: dict[str, EncoderEntry] = {entry.name: entry for entry in build_entries()}

ZOO_STATUS = {
    "implemented": sorted(n for n, x in ENTRIES.items() if x.implemented),
    "pending": sorted(n for n, x in ENTRIES.items() if not x.implemented),
}


# --- weight loading ------------------------------------------------------------------
def _find_cached_weights(entry: EncoderEntry) -> Path | None:
    """Search ATLASPATCH_WEIGHTS_DIR and the HF hub cache for this encoder."""
    wdir = os.environ.get("ATLASPATCH_WEIGHTS_DIR")
    if wdir:
        for ext in (".npz", ".safetensors", ".pt", ".pth", ".bin"):
            cand = Path(wdir) / f"{entry.name}{ext}"
            if cand.exists():
                return cand
    hub = Path(
        os.environ.get("HF_HUB_CACHE")
        or Path(os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface")) / "hub"
    )
    repo = entry.source.split()[0] if "/" in entry.source.split()[0] else None
    if repo:
        safe = repo.replace("/", "--")
        for ext in ("safetensors", "bin", "pth", "pt"):
            matches = sorted((hub / f"models--{safe}").glob(f"snapshots/*/*.{ext}"))
            if matches:
                # snapshot dirs are commit hashes: prefer the most recently
                # fetched revision; sharded checkpoints merge in _load_state_dict
                snap = max({m.parent for m in matches}, key=lambda d: d.stat().st_mtime)
                in_snap = sorted(m for m in matches if m.parent == snap)
                if in_snap:
                    return in_snap[0]
    return None


def _shard_group(path: Path) -> list[Path]:
    """All sibling files of a HF multi-shard checkpoint, else [path].

    Large models ship as model-00001-of-000NN.<ext>; loading one shard would
    produce a partial state dict (KeyError at convert time)."""
    m = re.match(r"(.+-)\d{5}-of-(\d{5})(\..+)$", path.name)
    if not m:
        return [path]
    total = int(m.group(2))
    shards = [
        path.parent / f"{m.group(1)}{i:05d}-of-{m.group(2)}{m.group(3)}"
        for i in range(1, total + 1)
    ]
    missing = [s.name for s in shards if not s.exists()]
    if missing:
        raise RuntimeError(
            f"sharded checkpoint {path.name}: missing shard(s) {missing}"
        )
    return shards


def _load_state_dict(path: Path) -> dict:
    """One checkpoint's tensors by name, the shards of a multi-shard one
    merged. ``.safetensors`` files are read by the port's own reader (CPU
    views of a map of the file); torch files by ``torch.load``, unwrapped
    from a ``model`` / ``state_dict`` / ``teacher`` entry."""
    import torch

    out: dict = {}
    for shard in _shard_group(path):
        if shard.suffix == ".safetensors":
            out.update(safetensors.load_file(shard))
            continue
        ckpt = torch.load(str(shard), map_location="cpu", weights_only=False)
        for key in ("model", "state_dict", "teacher"):
            if isinstance(ckpt, dict) and key in ckpt and isinstance(ckpt[key], dict):
                ckpt = ckpt[key]
        out.update({k: v for k, v in ckpt.items() if hasattr(v, "shape")})
    return out


def _strip_prefixes(sd: dict, prefixes=("module.", "model.", "backbone.")) -> dict:
    out = dict(sd)
    for prefix in prefixes:
        if any(k.startswith(prefix) for k in out):
            out = {k[len(prefix) :] if k.startswith(prefix) else k: v for k, v in out.items()}
    return out


def unflatten(flat: dict) -> dict:
    """A ``/``-joined flat archive (tools/convert_weights.py's .npz) → nested
    param tree (a copy of the JAX package's ``tools/convert_weights.unflatten``)."""
    tree: dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _convert_flax(entry: EncoderEntry, sd: dict) -> dict:
    """A source checkpoint's state_dict → the JAX package's param tree for
    ``entry`` (numpy arrays): the JAX ``zoo._convert``, family by family."""
    sd = _strip_prefixes(sd)
    family = entry.family
    if family in ("timm_vit",):
        params = C.timm_vit_to_flax(sd, entry.spec)
        if getattr(entry.spec, "proj_dim", None) and "proj" not in params:
            raise KeyError(
                f"{entry.name}: spec declares a {entry.spec.proj_dim}-d projection "
                "but the checkpoint has neither 'proj' nor 'proj.weight' — "
                "upstream naming changed; update convert.timm_vit_to_flax"
            )
        return params
    if family == "hf_vit":
        prefix = "vit." if any(k.startswith("vit.") for k in sd) else ""
        return C.hf_vit_to_flax(sd, entry.spec, prefix=prefix)
    if family == "dinov2":
        prefix = "dinov2." if any(k.startswith("dinov2.") for k in sd) else ""
        return C.hf_dinov2_to_flax(sd, entry.spec, prefix=prefix)
    if family == "dinov3":
        return C.hf_dinov3_to_flax(sd, entry.spec)
    if family == "clip_hf":
        return C.hf_clip_to_flax(sd, entry.spec)
    if family == "clip_openclip":
        return C.open_clip_vit_to_flax(sd, entry.spec)
    if family == "clip_timm_tower":
        return C.open_clip_timm_tower_to_flax(sd, entry.spec)
    if family == "siglip":
        return C.hf_siglip_to_flax(sd, entry.spec)
    if family == "torchvision_vit":
        return C.torchvision_vit_to_flax(sd, entry.spec)
    if family == "resnet":
        return torchvision_resnet_to_flax(sd, entry.spec)
    if family == "convnext":
        return torchvision_convnext_to_flax(sd, entry.spec)
    if family == "clip_modified_resnet":
        return open_clip_resnet_to_flax(sd, entry.spec)
    if family == "swin":
        if any("patch_embed.proj" in k for k in sd):
            return timm_swin_to_flax(sd, entry.spec)
        return hf_swin_to_flax(sd, entry.spec)
    if family == "coca":
        return open_clip_coca_to_flax(sd, entry.spec)
    if family == "conch":
        return conch_v1_to_flax(sd, entry.spec)
    if family == "beit3":
        return musk_beit3_to_flax(sd, entry.spec)
    raise NotImplementedError(f"no converter for family {family}")


def _convert(entry: EncoderEntry, sd: dict) -> dict:
    """A source checkpoint's state_dict → this package's state_dict for
    ``entry``: torchvision's ResNet and ConvNeXt keys as they are (the port's
    modules carry them), every other family through :func:`_convert_flax`
    and its tower's ``flax_*_to_torch``."""
    if entry.family == "resnet":
        return torchvision_resnet_to_torch(_strip_prefixes(sd))
    if entry.family == "convnext":
        return torchvision_convnext_to_torch(_strip_prefixes(sd))
    return _TOWERS[entry.family][1](_convert_flax(entry, sd))


_VIT_FAMILIES = (
    "timm_vit",
    "hf_vit",
    "dinov2",
    "dinov3",
    "clip_hf",
    "clip_openclip",
    "siglip",
    "torchvision_vit",
    "clip_timm_tower",
)

# family → (module class, JAX param tree → state_dict); the JAX _model_for.
# musk runs the MUSK wrapper's multi-scale forward (its stored 2048-d width).
_TOWERS = {
    **{family: (ViT, flax_tree_to_torch) for family in _VIT_FAMILIES},
    "resnet": (ResNet, flax_resnet_to_torch),
    "convnext": (ConvNeXt, flax_convnext_to_torch),
    "clip_modified_resnet": (ClipModifiedResNet, flax_clip_resnet_to_torch),
    "swin": (SwinNet, flax_swin_to_torch),
    "coca": (CoCaVisual, flax_coca_to_torch),
    "conch": (CoCaVisual, flax_coca_to_torch),
    "beit3": (MuskMsAug, flax_beit3_to_torch),
}


def build_extractor(
    entry: EncoderEntry,
    *,
    device: str = "cuda",
    mesh=None,
    tensor_parallel: bool = False,
    compute_dtype: str = "float32",
    max_batch: int = 256,
) -> TorchFeatureExtractor:
    if not entry.implemented:
        raise NotImplementedError(
            f"Encoder '{entry.name}' ({entry.family}) is registered but its tower is "
            f"not yet implemented in this build: {entry.notes}"
        )
    quant_int8 = compute_dtype == "int8"
    if quant_int8 and entry.family not in _VIT_FAMILIES:
        logger.warning(
            "int8 precision requested for %s (%s family): no int8 plan for this "
            "tower, falling back to bfloat16.",
            entry.name,
            entry.family,
        )
        quant_int8 = False
        compute_dtype = "bfloat16"
    if mesh is not None and tensor_parallel and entry.family not in _VIT_FAMILIES:
        logger.warning(
            "tensor_parallel requested for %s (%s family): no TP plan for this "
            "tower, replicating params (data-parallel only).",
            entry.name,
            entry.family,
        )
        tensor_parallel = False
    if mesh is not None:
        device = str(mesh.data_devices[0])  # the first replica's device
    tower, from_flax = _TOWERS[entry.family]
    with require_device(entry.name, device):  # built (and random-initialized) in place
        model = tower(entry.spec)
    weights_path = _find_cached_weights(entry)
    if weights_path is not None:
        logger.info("Loading %s weights from %s", entry.name, weights_path)
        if weights_path.suffix == ".npz":
            state = from_flax(unflatten(dict(np.load(weights_path))))
        else:
            state = _convert(entry, _load_state_dict(weights_path))
        model.load_state_dict(state, strict=True)
    elif os.environ.get("ATLASPATCH_ALLOW_RANDOM_WEIGHTS") == "1":
        logger.warning("No weights for %s; using deterministic random init.", entry.name)
        init_random_weights_(model, seed=0)
    else:
        raise RuntimeError(
            f"No cached weights found for encoder '{entry.name}' (source: {entry.source}). "
            "Place a checkpoint in ATLASPATCH_WEIGHTS_DIR or the HF cache, or set "
            "ATLASPATCH_ALLOW_RANDOM_WEIGHTS=1 for benchmarking."
        )
    if quant_int8:
        # The float32 weights (from file, or the float model's random init,
        # so int8 and float runs share weights), quantized into the W8A8 ViT.
        state = quantize_vit_state_dict(model.state_dict())
        with require_device(entry.name, device):
            model = tower(replace(entry.spec, quant_int8=True))
        model.load_state_dict(state, strict=True)
    return TorchFeatureExtractor(
        name=entry.name,
        embedding_dim=entry.embedding_dim,
        spec=entry.preprocess,
        model=model,
        device=device,
        mesh=mesh,
        tensor_parallel=mesh is not None and tensor_parallel,
        compute_dtype=compute_dtype,
        max_batch=max_batch,
    )


def build_default_registry(
    *,
    device: str = "cuda",
    num_workers: int = 0,
    dtype: str = "float32",
    mesh=None,
    tensor_parallel: bool = False,
) -> PatchFeatureExtractorRegistry:
    """Registry with all 66 reference names (API parity: reference
    models/patch/__init__.py:47-80). Builders are lazy; nothing loads, and the
    device is not touched, until create()."""
    del num_workers  # host prep threads are managed by the engine
    dtype_s = str(dtype).lower()
    if dtype_s == "int8":
        compute_dtype = "int8"
    elif dtype_s in ("bfloat16", "float16", "bf16"):
        compute_dtype = "bfloat16"
    else:
        compute_dtype = "float32"
    registry = PatchFeatureExtractorRegistry()
    for entry in ENTRIES.values():
        registry.register(
            entry.name,
            lambda en=entry: build_extractor(
                en,
                device=str(device),
                mesh=mesh,
                tensor_parallel=tensor_parallel,
                compute_dtype=compute_dtype,
            ),
        )
    return registry
