"""Torchvision-style ConvNeXt in PyTorch (tiny/small/base/large).

The port of ``atlaspatch_tpu/models/encoders/convnext.py``. Reference
behavior: the whole classifier (LayerNorm2d + flatten + linear) is replaced by
Identity, so features are the *pre-norm* global-average-pooled map flattened
to (N, C) (reference: atlas_patch/models/patch/convnext.py:25-37 with
base.py:101-103 — SURVEY.md §2 row 22).

The module carries torchvision's key layout: ``features.0`` = stem (conv +
LayerNorm2d); ``features.{2,4,6}`` = downsample (LayerNorm2d + conv);
``features.{1,3,5,7}`` = stages of CNBlocks, each ``block.{0 dwconv, 2 LN,
3 linear, 5 linear}`` and ``layer_scale``. A torchvision ``state_dict``
loads as it is without its ``classifier`` (:func:`torchvision_convnext_to_torch`);
:func:`flax_convnext_to_torch` carries the JAX package's param tree across.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class ConvNeXtSpec:
    depths: tuple[int, ...]
    dims: tuple[int, ...]

    @property
    def embedding_dim(self) -> int:
        return self.dims[-1]


CONVNEXT_SPECS = {
    "convnext_tiny": ConvNeXtSpec((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ConvNeXtSpec((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ConvNeXtSpec((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ConvNeXtSpec((3, 3, 27, 3), (192, 384, 768, 1536)),
}

LN_EPS = 1e-6


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Permute(nn.Module):
    def __init__(self, dims: tuple[int, ...]) -> None:
        super().__init__()
        self.dims = dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(*self.dims)


class CNBlock(nn.Module):
    """7x7 depthwise conv → LayerNorm over channels → Linear 4x → exact GELU
    → Linear → layer scale, plus the residual."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim, 7, padding=3, groups=dim),
            Permute((0, 2, 3, 1)),
            nn.LayerNorm(dim, eps=LN_EPS),
            nn.Linear(dim, 4 * dim),
            nn.GELU(approximate="none"),
            nn.Linear(4 * dim, dim),
            Permute((0, 3, 1, 2)),
        )
        self.layer_scale = nn.Parameter(torch.ones(dim, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layer_scale * self.block(x)


class ConvNeXt(nn.Module):
    def __init__(self, spec: ConvNeXtSpec) -> None:
        super().__init__()
        self.spec = spec
        layers: list[nn.Module] = [
            nn.Sequential(nn.Conv2d(3, spec.dims[0], 4, stride=4), LayerNorm2d(spec.dims[0], eps=LN_EPS))
        ]
        for stage, (depth, dim) in enumerate(zip(spec.depths, spec.dims)):
            if stage > 0:
                layers.append(
                    nn.Sequential(
                        LayerNorm2d(spec.dims[stage - 1], eps=LN_EPS),
                        nn.Conv2d(spec.dims[stage - 1], dim, 2, stride=2),
                    )
                )
            layers.append(nn.Sequential(*(CNBlock(dim) for _ in range(depth))))
        self.features = nn.Sequential(*layers)
        self.to(memory_format=torch.channels_last)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized → (B, C) pooled pre-norm features."""
        x = self.features(images.permute(0, 3, 1, 2))  # NCHW view of channels-last memory
        return x.mean(dim=(2, 3))


def torchvision_convnext_to_torch(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A torchvision ConvNeXt state_dict → this module's: the same keys,
    without the ``classifier`` head."""
    return {k: torch.as_tensor(v).float() for k, v in sd.items() if not k.startswith("classifier.")}


def torchvision_convnext_to_flax(sd, spec: ConvNeXtSpec) -> dict:
    """torchvision convnext state dict → the JAX package's Flax params: the
    JAX converter's copy, for ``tools/convert_weights.py``."""
    from atlaspatch_tpu_torch.models.encoders.convert import _np as np_

    def conv(key):
        return {
            "kernel": np_(sd[f"{key}.weight"]).transpose(2, 3, 1, 0),
            "bias": np_(sd[f"{key}.bias"]),
        }

    def ln(key):
        return {"scale": np_(sd[f"{key}.weight"]), "bias": np_(sd[f"{key}.bias"])}

    def lin(key):
        return {"kernel": np_(sd[f"{key}.weight"]).T, "bias": np_(sd[f"{key}.bias"])}

    params: dict = {
        "stem_conv": conv("features.0.0"),
        "stem_norm": ln("features.0.1"),
    }
    for stage in range(4):
        feat_idx = 1 + 2 * stage
        if stage > 0:
            params[f"down{stage}_norm"] = ln(f"features.{feat_idx - 1}.0")
            params[f"down{stage}_conv"] = conv(f"features.{feat_idx - 1}.1")
        for b in range(spec.depths[stage]):
            src = f"features.{feat_idx}.{b}.block"
            params[f"stage{stage}_block{b}"] = {
                "dwconv": conv(f"{src}.0"),  # (C, 1, 7, 7) → (7, 7, 1, C)
                "norm": ln(f"{src}.2"),
                "pw1": lin(f"{src}.3"),
                "pw2": lin(f"{src}.5"),
                "gamma": np_(sd[f"features.{feat_idx}.{b}.layer_scale"]).reshape(-1),
            }
    return params


def flax_convnext_to_torch(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's ConvNeXt param tree (numpy or jax arrays) → this
    module's state_dict. Conv kernels (kh, kw, in, out) → weight (out, in,
    kh, kw) (a depthwise (7, 7, 1, C) → (C, 1, 7, 7)); Dense kernels (in,
    out) → weight (out, in); LayerNorm ``scale`` → ``weight``; ``gamma`` (C,)
    → ``layer_scale`` (C, 1, 1)."""
    where = {"stem_conv": "features.0.0", "stem_norm": "features.0.1"}
    block_parts = {"dwconv": "block.0", "norm": "block.2", "pw1": "block.3", "pw2": "block.5"}
    out: dict[str, torch.Tensor] = {}

    def put(key: str, arr) -> None:
        out[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(arr, dtype=np.float32)))

    def put_layer(prefix: str, node: Mapping[str, Any]) -> None:
        for leaf, arr in node.items():
            arr = np.asarray(arr, dtype=np.float32)
            if leaf == "kernel":
                arr, leaf = (arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T), "weight"
            elif leaf == "scale":
                leaf = "weight"
            put(f"{prefix}.{leaf}", arr)

    for name, node in params.items():
        down = re.fullmatch(r"down(\d+)_(norm|conv)", name)
        block = re.fullmatch(r"stage(\d+)_block(\d+)", name)
        if name in where:
            put_layer(where[name], node)
        elif down:
            put_layer(f"features.{2 * int(down.group(1))}.{0 if down.group(2) == 'norm' else 1}", node)
        elif block:
            prefix = f"features.{2 * int(block.group(1)) + 1}.{block.group(2)}"
            for part, sub in node.items():
                if part == "gamma":
                    put(f"{prefix}.layer_scale", np.asarray(sub).reshape(-1, 1, 1))
                else:
                    put_layer(f"{prefix}.{block_parts[part]}", sub)
        else:
            raise KeyError(f"unknown ConvNeXt param group {name!r}")
    return out
