"""CLIP's ModifiedResNet visual tower in PyTorch (clip_rn50/101/50x4/50x16/50x64).

The port of ``atlaspatch_tpu/models/encoders/clip_resnet.py``. Architecture
(reference encoders: atlas_patch/models/patch/clip.py:13-23 via open_clip
"openai" weights): a 3-conv stem with an avg-pool, anti-aliased Bottlenecks
(a stride is an avg-pool before the 1x1, never a strided conv), and a global
attention-pool head: the query is the mean token alone, the keys and values
the mean token and the spatial grid, each with a learned positional
embedding. The convolutions run on cuDNN in the channels-last layout the
engine's (N, H, W, 3) images give; BatchNorm uses stored statistics.

Module names mirror the Flax tree (``layer{i}_{b}``, ``downsample_conv``,
``attnpool.q_proj``), so :func:`flax_clip_resnet_to_torch` is the shared
walker; :func:`open_clip_resnet_to_flax` is the JAX converter's copy.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from atlaspatch_tpu_torch.models.encoders.convert import _np
from atlaspatch_tpu_torch.models.encoders.resnet import FrozenBatchNorm
from atlaspatch_tpu_torch.models.encoders.vit import flax_tree_to_torch


@dataclass(frozen=True)
class ClipResNetSpec:
    layers: tuple[int, ...]
    width: int
    embed_dim: int  # attnpool output dim
    heads: int
    image_size: int

    @property
    def final_channels(self) -> int:
        return self.width * 32

    @property
    def spacial_dim(self) -> int:
        return self.image_size // 32


CLIP_RESNET_SPECS = {
    "clip_rn50": ClipResNetSpec((3, 4, 6, 3), 64, 1024, 32, 224),
    "clip_rn101": ClipResNetSpec((3, 4, 23, 3), 64, 512, 32, 224),
    "clip_rn50x4": ClipResNetSpec((4, 6, 10, 6), 80, 640, 40, 288),
    "clip_rn50x16": ClipResNetSpec((6, 8, 18, 8), 96, 768, 48, 384),
    "clip_rn50x64": ClipResNetSpec((3, 15, 36, 10), 128, 1024, 64, 448),
}


def _avg_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The anti-aliased stride: a ``stride``-window average, no padding."""
    return F.avg_pool2d(x, kernel_size=stride, stride=stride)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


class ClipBottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False) -> None:
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = _conv(cin, planes, 1), FrozenBatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), FrozenBatchNorm(planes)
        self.conv3, self.bn3 = _conv(planes, planes * 4, 1), FrozenBatchNorm(planes * 4)
        if downsample:
            self.downsample_conv = _conv(cin, planes * 4, 1)
            self.downsample_bn = FrozenBatchNorm(planes * 4)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = _avg_pool(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample_conv is not None:
            if self.stride > 1:
                identity = _avg_pool(identity, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    def __init__(self, spec: ClipResNetSpec) -> None:
        super().__init__()
        self.spec = spec
        c = spec.final_channels
        self.positional_embedding = nn.Parameter(torch.zeros(spec.spacial_dim**2 + 1, c))
        self.q_proj, self.k_proj, self.v_proj = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)
        self.c_proj = nn.Linear(c, spec.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) → (B, embed_dim): attention with a mean query token."""
        B, C, H, W = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(B, H * W, C)  # row-major, as the NHWC reshape
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)  # (B, HW+1, C)
        tokens = tokens + self.positional_embedding[None].to(tokens.dtype)
        heads = self.spec.heads
        head_dim = C // heads

        def split(t):
            return t.reshape(B, -1, heads, head_dim).transpose(1, 2)

        q = self.q_proj(tokens[:, :1])
        attn = torch.einsum("bhqd,bhkd->bhqk", split(q), split(self.k_proj(tokens))) * (head_dim**-0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, split(self.v_proj(tokens)))
        return self.c_proj(out.transpose(1, 2).reshape(B, 1, C))[:, 0]


class ClipModifiedResNet(nn.Module):
    """(B, S, S, 3) normalized images → (B, embed_dim) attention-pooled features."""

    def __init__(self, spec: ClipResNetSpec) -> None:
        super().__init__()
        self.spec = spec
        half = spec.width // 2
        self.conv1 = nn.Conv2d(3, half, 3, stride=2, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm(half)
        self.conv2, self.bn2 = _conv(half, half, 3), FrozenBatchNorm(half)
        self.conv3, self.bn3 = _conv(half, spec.width, 3), FrozenBatchNorm(spec.width)
        inplanes = spec.width
        for stage, n_blocks in enumerate(spec.layers):
            planes = spec.width * 2**stage
            stride = 1 if stage == 0 else 2
            for b in range(n_blocks):
                needs_down = b == 0 and (stride > 1 or inplanes != planes * 4)
                self.add_module(f"layer{stage + 1}_{b}",
                                ClipBottleneck(inplanes, planes, stride if b == 0 else 1, needs_down))
                inplanes = planes * 4
        self.attnpool = AttentionPool2d(spec)
        self.to(memory_format=torch.channels_last)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = _avg_pool(x, 2)
        for stage, n_blocks in enumerate(self.spec.layers):
            for b in range(n_blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
        return self.attnpool(x)


flax_clip_resnet_to_torch = flax_tree_to_torch


def open_clip_resnet_to_flax(sd, spec: ClipResNetSpec, prefix: str = "visual.") -> dict:
    """open_clip/openai ModifiedResNet state dict → Flax params."""

    np_ = _np  # shared torch->numpy helper (convert.py)

    def conv(key):
        return {"kernel": np_(sd[f"{prefix}{key}.weight"]).transpose(2, 3, 1, 0)}

    def bn(key):
        return {
            "scale": np_(sd[f"{prefix}{key}.weight"]),
            "bias": np_(sd[f"{prefix}{key}.bias"]),
            "mean": np_(sd[f"{prefix}{key}.running_mean"]),
            "var": np_(sd[f"{prefix}{key}.running_var"]),
        }

    def lin(key):
        return {
            "kernel": np_(sd[f"{prefix}{key}.weight"]).T,
            "bias": np_(sd[f"{prefix}{key}.bias"]),
        }

    params: dict = {
        "conv1": conv("conv1"), "bn1": bn("bn1"),
        "conv2": conv("conv2"), "bn2": bn("bn2"),
        "conv3": conv("conv3"), "bn3": bn("bn3"),
    }
    for stage, n_blocks in enumerate(spec.layers):
        for b in range(n_blocks):
            src = f"layer{stage + 1}.{b}"
            block: dict = {}
            for c in (1, 2, 3):
                block[f"conv{c}"] = conv(f"{src}.conv{c}")
                block[f"bn{c}"] = bn(f"{src}.bn{c}")
            if f"{prefix}{src}.downsample.0.weight" in sd:
                block["downsample_conv"] = conv(f"{src}.downsample.0")
                block["downsample_bn"] = bn(f"{src}.downsample.1")
            params[f"layer{stage + 1}_{b}"] = block
    params["attnpool"] = {
        "positional_embedding": np_(sd[f"{prefix}attnpool.positional_embedding"]),
        "q_proj": lin("attnpool.q_proj"),
        "k_proj": lin("attnpool.k_proj"),
        "v_proj": lin("attnpool.v_proj"),
        "c_proj": lin("attnpool.c_proj"),
    }
    return params
