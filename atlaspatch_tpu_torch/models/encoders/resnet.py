"""Torchvision-style ResNet in PyTorch (v1: BasicBlock / Bottleneck).

The port of ``atlaspatch_tpu/models/encoders/resnet.py``. Covers
resnet18/34/50/101/152 (reference: atlas_patch/models/patch/resnet.py:9-38,
head fc→Identity so features are the post-avgpool vector) and the Lunit
self-supervised ResNet50 variants (reference: lunit.py:13-17, same
architecture). BatchNorm runs in inference mode with stored running stats,
in the JAX package's folded form ``x * inv + (bias - mean * inv)``.

The module carries torchvision's key names (``conv1``, ``bn1``,
``layer{i}.{b}.conv{1,2,3}``, ``downsample.{0,1}``), so a torchvision or
timm ``state_dict`` loads as it is, its ``fc`` head and BatchNorm
``num_batches_tracked`` counters dropped (:func:`torchvision_resnet_to_torch`).
:func:`flax_resnet_to_torch` carries the JAX package's param tree across.
Images come in as (N, H, W, 3), as the engine hands them; the convolutions
run on cuDNN in the channels-last layout that gives without a copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class ResNetSpec:
    layers: tuple[int, ...]
    bottleneck: bool

    @property
    def embedding_dim(self) -> int:
        return 512 * (4 if self.bottleneck else 1)


RESNET_SPECS = {
    "resnet18": ResNetSpec((2, 2, 2, 2), False),
    "resnet34": ResNetSpec((3, 4, 6, 3), False),
    "resnet50": ResNetSpec((3, 4, 6, 3), True),
    "resnet101": ResNetSpec((3, 4, 23, 3), True),
    "resnet152": ResNetSpec((3, 8, 36, 3), True),
}


class FrozenBatchNorm(nn.Module):
    """Inference-mode batch norm using stored running statistics."""

    def __init__(self, features: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)  # a training counter
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False), FrozenBatchNorm(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False) -> None:
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = FrozenBatchNorm(features)
        self.downsample = _downsample(cin, features, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False) -> None:
        super().__init__()
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = _conv(features, features * 4, 1)
        self.bn3 = FrozenBatchNorm(features * 4)
        self.downsample = _downsample(cin, features * 4, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, spec: ResNetSpec) -> None:
        super().__init__()
        self.spec = spec
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        block_cls = Bottleneck if spec.bottleneck else BasicBlock
        cin = 64
        for stage, n_blocks in enumerate(spec.layers):
            features = 64 * 2**stage
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                needs_down = b == 0 and (stride != 1 or cin != features * block_cls.expansion)
                blocks.append(block_cls(cin, features, stride if b == 0 else 1, needs_down))
                cin = features * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.to(memory_format=torch.channels_last)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized → (B, embedding_dim) global-avg-pool features."""
        x = images.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for stage in range(len(self.spec.layers)):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean(dim=(2, 3))


def torchvision_resnet_to_torch(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A torchvision (or timm) ResNet state_dict → this module's: the same
    keys, without the ``fc`` head and the ``num_batches_tracked`` counters."""
    return {
        k: torch.as_tensor(v).float()
        for k, v in sd.items()
        if not k.startswith("fc.") and not k.endswith("num_batches_tracked")
    }


def torchvision_resnet_to_flax(sd, spec: ResNetSpec) -> dict:
    """torchvision resnet state dict → the JAX package's Flax params (fc head
    dropped): the JAX converter's copy, for ``tools/convert_weights.py``."""
    from atlaspatch_tpu_torch.models.encoders.convert import _np as np_

    def conv(key):
        return {"kernel": np_(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)}

    def bn(key):
        return {
            "scale": np_(sd[f"{key}.weight"]),
            "bias": np_(sd[f"{key}.bias"]),
            "mean": np_(sd[f"{key}.running_mean"]),
            "var": np_(sd[f"{key}.running_var"]),
        }

    params: dict = {"conv1": conv("conv1"), "bn1": bn("bn1")}
    n_convs = 3 if spec.bottleneck else 2
    for stage, n_blocks in enumerate(spec.layers):
        for b in range(n_blocks):
            src = f"layer{stage + 1}.{b}"
            block: dict = {}
            for c in range(1, n_convs + 1):
                block[f"conv{c}"] = conv(f"{src}.conv{c}")
                block[f"bn{c}"] = bn(f"{src}.bn{c}")
            if f"{src}.downsample.0.weight" in sd:
                block["downsample_conv"] = conv(f"{src}.downsample.0")
                block["downsample_bn"] = bn(f"{src}.downsample.1")
            params[f"layer{stage + 1}_{b}"] = block
    return params


def flax_resnet_to_torch(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's ResNet param tree (numpy or jax arrays) → this
    module's state_dict: ``layer{i}_{b}`` → ``layer{i}.{b}``,
    ``downsample_{conv,bn}`` → ``downsample.{0,1}``, Conv kernels (kh, kw,
    in, out) → weight (out, in, kh, kw), BatchNorm scale / bias / mean / var
    → weight / bias / running_mean / running_var."""
    bn_names = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    sub_names = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, value in node.items():
                key = str(key)
                if key.startswith("layer"):
                    key = key.replace("_", ".", 1)
                walk(value, path + [sub_names.get(key, key)])
            return
        arr = np.asarray(node, dtype=np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            arr, leaf = arr.transpose(3, 2, 0, 1), "weight"
        else:
            leaf = bn_names[leaf]
        out[".".join(path[:-1] + [leaf])] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(params, [])
    return out
