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
:func:`flax_vit_to_torch` converts one to the other.

The int8 serving mode (W8A8, ``spec.quant_int8``): the block linears
(``QUANT_LAYER_NAMES`` under ``blocks``) are :class:`Int8Linear`, the port of
the reference's ``Int8Dense`` (vit.py:124-157), whose quantizer and int8
product run as the kernels of ``ops/int8.py`` on the card; the parameters
take the layout of :func:`quantize_vit_params` (a Flax tree) or
:func:`quantize_vit_state_dict` (a state_dict), which give the same int8
weights and scales. The quantizer takes in the op before it, as XLA fuses
them on the TPU: ``Block`` quantizes ``norm1(x)`` and ``norm2(x)`` in one
pass (``layernorm_quantize_rows``; a gated MLP's two linears share the
rows), ``Mlp`` its activation (``act_quantize_rows``), ``Attention`` the
attention's output where it lies (``quantize_heads``); each hands the
linear :class:`QuantizedRows`. On the CPU these run the unfused ops. GELU is
the tanh approximation there unless ``ATLASPATCH_GELU_TANH=0``.
``spec.quant_int8_attn`` also runs QK^T and PV as int8 products
(vit.py:237-260); no entry point turns it on.

Tensor parallelism (``parallel/sharding.py``): ``Attention`` and ``Mlp``
take ``shards``, and then hold one slice of the heads or hidden units and
map the whole input to a partial output without its bias; a
:class:`RowParallel` sums the shards' partials, each on its own device, and
adds the bias once; the block adds layerscale and residual after that. In
the int8 serving mode the shards hand ``RowParallel`` two halves instead
(``row_amax``, ``row_partial``): the abs-max of their slice of the
row-parallel linear's input rows, maxed across the shards, then that slice
quantized with the whole row's scale and multiplied in int32; the int32
partials are summed and dequantized once (``dequant_sum``), as the JAX
program's collectives do, so the result is one device's bit for bit.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, replace
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from atlaspatch_tpu_torch.ops.int8 import (
    ACTIVATIONS, act_quantize_rows, act_row_amax, dequant_sum, heads_amax, int8_linear, int8_linear_s32, int_product,
    layernorm_quantize_rows, quantize_heads, quantize_plain, quantize_rows,
)


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
    # W8A8 serving mode: the block linears run int8 x int8 -> int32 on the
    # tensor cores (Int8Linear). Opt-in via --feature-precision int8; params
    # use the quantized layout of quantize_vit_params().
    quant_int8: bool = False
    # With quant_int8: QK^T and PV as int8 products too (dynamic per-row and
    # per-channel scales; softmax stays float32). Off by default.
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


def _act_name(name: str, quantized: bool = False) -> str:
    """The activation's name as the module runs it. The exact erf GELU
    becomes the tanh approximation by default in the int8 serving mode
    (``quantized``), whose contract is already small drift;
    ``ATLASPATCH_GELU_TANH=1`` / ``0`` forces it on / off everywhere. Read
    when the module is built."""
    if name == "gelu":
        env = os.environ.get("ATLASPATCH_GELU_TANH")
        if env == "1" or (quantized and env != "0"):
            return "gelu_tanh"
    return name


def _act(name: str, quantized: bool = False):
    """The activation by name (``ops/int8.py::ACTIVATIONS``), after
    ``_act_name``."""
    return ACTIVATIONS[_act_name(name, quantized)]


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


@dataclass(frozen=True)
class QuantizedRows:
    """The rows of a (..., K) tensor of ``shape`` and ``dtype`` quantized for
    an :class:`Int8Linear`: ``xq`` (M, K) int8 and ``s_x`` (M,) float32, M
    the product of the leading dims. Built by the op that fused the quantizer
    in, so the float rows are never stored."""

    xq: torch.Tensor
    s_x: torch.Tensor
    shape: tuple
    dtype: torch.dtype

    def to(self, device: torch.device | str) -> "QuantizedRows":
        """The same rows on ``device`` (a tensor-parallel shard's)."""
        return QuantizedRows(self.xq.to(device), self.s_x.to(device), self.shape, self.dtype)


class Int8Linear(nn.Module):
    """W8A8 dynamic-quantized linear layer (the int8 serving mode), the port
    of the reference's ``Int8Dense``.

    Weights: symmetric per-output-channel int8 ``weight_q`` (N, K) with
    float32 ``qscale`` (N,), both buffers. Activations: symmetric per-row
    dynamic abs-max int8, quantized here (``quantize_rows``) or handed in as
    :class:`QuantizedRows`. The int8 product accumulates in int32 and is
    dequantized by one float32 multiply by both scales, plus the bias, in the
    activations' dtype out (``int8_linear``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True) -> None:
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("qscale", torch.full((out_features,), 1.0 / 127.0, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor | QuantizedRows) -> torch.Tensor:
        if not isinstance(x, QuantizedRows):
            x = QuantizedRows(*quantize_rows(x.reshape(-1, self.in_features)), tuple(x.shape), x.dtype)
        y = int8_linear(x.xq, x.s_x, self.weight_q, self.qscale, self.bias, x.dtype)
        return y.reshape(*x.shape[:-1], self.out_features)


# Block-level layers eligible for int8 (they must sit under ``blocks``).
QUANT_LAYER_NAMES = ("qkv", "proj", "fc1", "fc2", "fc_gate", "fc_up")


def _linear(spec: ViTSpec, in_features: int, out_features: int, bias: bool = True) -> nn.Module:
    """Block-level linear: Int8Linear in the int8 serving mode, nn.Linear
    otherwise. Only transformer-block layers quantize; embeddings, pooling
    heads and projections stay float."""
    if spec.quant_int8:
        return Int8Linear(in_features, out_features, bias=bias)
    return nn.Linear(in_features, out_features, bias=bias)


def quantize_vit_params(params):
    """Standard float ViT param tree (numpy) → the Int8Dense layout, as the
    reference's ``quantize_vit_params`` (vit.py:171-199).

    Per-output-channel symmetric scales over each eligible block kernel:
    kernel (K, N) f32 → kernel_q (K, N) int8 + qscale (N,) f32; biases pass
    through. Everything outside blocks_* is untouched."""

    def walk(node, path):
        if isinstance(node, dict):
            if (
                "kernel" in node
                and path
                and path[-1] in QUANT_LAYER_NAMES
                and any(str(p).startswith("blocks_") for p in path)
            ):
                w = np.asarray(node["kernel"], np.float32)
                s = np.maximum(np.abs(w).max(axis=0), 1e-8) / 127.0
                kq = np.clip(np.round(w / s), -127, 127).astype(np.int8)
                out = {"kernel_q": kq, "qscale": s.astype(np.float32)}
                if "bias" in node:
                    out["bias"] = np.asarray(node["bias"], np.float32)
                return out
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    return walk(params, ())


def quantize_vit_state_dict(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A float ViT state_dict → the Int8Linear layout, on the tensors' own
    device: ``blocks.*.<layer>.weight`` (N, K) of a layer in
    QUANT_LAYER_NAMES → ``weight_q`` (N, K) int8 + ``qscale`` (N,) float32,
    its bias as float32; the rest as it is. Gives the int8 weights and scales
    of :func:`quantize_vit_params`, bit for bit."""
    out: dict[str, torch.Tensor] = {}
    for key, value in state.items():
        parts = key.split(".")
        if parts[-1] in ("weight", "bias") and len(parts) > 2 and parts[-2] in QUANT_LAYER_NAMES \
                and "blocks" in parts[:-2]:
            prefix = key[: -len(parts[-1])]
            if parts[-1] == "bias":
                out[key] = value.float()
            else:
                weight_q, qscale = quantize_plain(value.float(), dim=1)
                out[prefix + "weight_q"] = weight_q
                out[prefix + "qscale"] = qscale[:, 0]
        else:
            out[key] = value
    return out


def _int8_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(QK^T * scale) V with both products int8 (vit.py:237-260): QK^T
    with per-(b, t, h) dynamic scales on both sides, PV with per-row
    probability scales times per-(b, h, channel) value scales; the softmax in
    float32. (B, T, H, D) in, (B, T, H, D) float32 out. The products are
    exact (``int_product``)."""
    qq, sq = quantize_plain(q.float(), -1)  # (B, T, H, 1)
    kq, sk = quantize_plain(k.float(), -1)
    acc = int_product("bqhd,bkhd->bhqk", qq, kq)
    attn = acc.float() * (sq.permute(0, 2, 1, 3) * sk.permute(0, 2, 3, 1))
    attn = attn * (q.shape[-1] ** -0.5)
    e = torch.exp(attn - attn.amax(dim=-1, keepdim=True))
    attn = e / e.sum(dim=-1, keepdim=True)
    aq, sa = quantize_plain(attn, -1)  # (B, H, Tq, 1)
    vq, sv = quantize_plain(v.float(), 1)  # scale (B, 1, H, D)
    acc2 = int_product("bhqk,bkhd->bhqd", aq, vq)
    out = acc2.float() * (sa * sv.permute(0, 2, 1, 3))
    return out.permute(0, 2, 1, 3)


class Attention(nn.Module):
    """Multi-head self-attention; with ``shards`` > 1, one of that many
    equal slices of the heads, whose ``proj`` has no bias (the sum of the
    slices' outputs is the layer's, before its bias)."""

    def __init__(self, spec: ViTSpec, shards: int = 1) -> None:
        super().__init__()
        self.spec = spec
        self.heads, self.head_dim = spec.heads // shards, spec.dim // spec.heads
        width = self.heads * self.head_dim
        self.qkv = _linear(spec, spec.dim, 3 * width, bias=spec.qkv_bias)
        self.proj = _linear(spec, width, spec.dim, bias=shards == 1)
        if spec.pos_mode == "rope":
            cos, sin = _rope_cos_sin(spec)
            self.register_buffer("rope_cos", cos, persistent=False)
            self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def row_linear(self) -> nn.Module:
        """The row-parallel linear under tensor parallelism."""
        return self.proj

    def forward(self, x: torch.Tensor | QuantizedRows) -> torch.Tensor:
        out = self.attend(x)
        B, T = out.shape[:2]
        width = self.heads * self.head_dim
        if self.spec.quant_int8:  # (B, T, H, D) quantized where it lies, not reshaped into a copy first
            return self.proj(QuantizedRows(*quantize_heads(out), (B, T, width), out.dtype))
        return self.proj(out.reshape(B, T, width))

    def row_amax(self, x: QuantizedRows) -> tuple[torch.Tensor, torch.Tensor]:
        """Tensor-parallel int8, a shard's first half: its heads' output (B,
        T, H, D) before ``proj`` and the (B T,) abs-max of its slice of each
        row."""
        out = self.attend(x)
        return out, heads_amax(out)

    def row_partial(self, out: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The second half: ``out`` quantized with the whole row's ``amax``,
        times ``proj``'s input columns of these heads, in int32: ((B T, dim)
        int32 partial, s_x (B T,))."""
        xq, s_x = quantize_heads(out, amax)
        return int8_linear_s32(xq, self.proj.weight_q), s_x

    def attend(self, x: torch.Tensor | QuantizedRows) -> torch.Tensor:
        """The heads' output before ``proj``, (B, T, H, D) in x's dtype."""
        s = self.spec
        B, T, _ = x.shape
        # token-major (B, T, H, D) throughout, as the reference keeps it
        q, k, v = self.qkv(x).reshape(B, T, 3, self.heads, self.head_dim).unbind(2)
        if s.pos_mode == "rope":
            cos = self.rope_cos.to(q.dtype)[None, :, None, :]  # (1, T_patch, 1, D)
            sin = self.rope_sin.to(q.dtype)[None, :, None, :]
            n_prefix = T - cos.shape[1]
            qp, kp = q[:, n_prefix:], k[:, n_prefix:]
            qp = qp * cos + _rotate_half(qp) * sin
            kp = kp * cos + _rotate_half(kp) * sin
            q = torch.cat([q[:, :n_prefix], qp], dim=1)
            k = torch.cat([k[:, :n_prefix], kp], dim=1)
        if s.quant_int8 and s.quant_int8_attn:
            return _int8_attention(q, k, v).to(x.dtype)
        return _softmax_attention(q, k, v, "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd")


class Mlp(nn.Module):
    """The block MLP; with ``shards`` > 1, one of that many equal slices of
    the hidden units (of each half of a SwiGLU-packed ``fc1``), whose
    ``fc2`` has no bias."""

    def __init__(self, spec: ViTSpec, shards: int = 1) -> None:
        super().__init__()
        self.spec = spec
        self.act_name = _act_name(spec.act, spec.quant_int8)
        self.act = ACTIVATIONS[self.act_name]
        hidden = spec.hidden_dim // shards
        if spec.gated_mlp:
            self.fc_gate = _linear(spec, spec.dim, hidden)
            self.fc_up = _linear(spec, spec.dim, hidden)
        else:
            self.fc1 = _linear(spec, spec.dim, 2 * hidden if spec.swiglu else hidden)
        self.fc2 = _linear(spec, hidden, spec.dim, bias=shards == 1)

    @property
    def row_linear(self) -> nn.Module:
        """The row-parallel linear under tensor parallelism."""
        return self.fc2

    def forward(self, x: torch.Tensor | QuantizedRows) -> torch.Tensor:
        a, b = self._hidden(x)
        if self.spec.quant_int8:  # act(a) (* b) quantized in one pass, never stored
            rows = _rows(a, b)
            return self.fc2(QuantizedRows(*act_quantize_rows(rows[0], self.act_name, rows[1]), tuple(a.shape),
                                          a.dtype))
        return self.fc2(self.act(a) if b is None else self.act(a) * b)

    def row_amax(self, x: QuantizedRows) -> tuple[tuple, torch.Tensor]:
        """Tensor-parallel int8, a shard's first half: its hidden units' (M,
        F) rows ``a`` and ``b`` (None without a gate) and the (M,) abs-max of
        its slice of each row of ``act(a) (* b)``."""
        rows = _rows(*self._hidden(x))
        return rows, act_row_amax(rows[0], self.act_name, rows[1])

    def row_partial(self, rows: tuple, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The second half: ``act(a) (* b)`` quantized with the whole row's
        ``amax``, times ``fc2``'s input columns of these units, in int32:
        ((M, dim) int32 partial, s_x (M,))."""
        xq, s_x = act_quantize_rows(rows[0], self.act_name, rows[1], amax)
        return int8_linear_s32(xq, self.fc2.weight_q), s_x

    def _hidden(self, x):
        """The hidden units before the activation: (a, b), b None without a gate."""
        if self.spec.gated_mlp:
            return self.fc_gate(x), self.fc_up(x)
        if self.spec.swiglu:
            return self.fc1(x).chunk(2, dim=-1)
        return self.fc1(x), None


def _rows(a: torch.Tensor, b: torch.Tensor | None) -> tuple:
    """(..., F) hidden units → (M, F) rows, views where they lie."""
    return a.reshape(-1, a.shape[-1]), None if b is None else b.reshape(-1, b.shape[-1])


class RowParallel(nn.Module):
    """A layer split over devices: each shard (an ``Attention`` or ``Mlp``
    with ``shards`` > 1, on its own device) maps the same input to a
    partial output; the partials are summed on the first shard's device in
    shard order, in float32, and the layer's output bias is added once,
    after the sum. In the int8 serving mode the shards' row-parallel
    quantizer takes the row's abs-max across them, their partials are int32
    and ``dequant_sum`` sums and dequantizes them once on the first device,
    with the row-parallel linear's whole ``qscale`` (every shard holds it;
    the first's is read) and the bias: one device's result, bit for bit.
    Built by ``parallel/sharding.py::shard_vit``; never moved as a whole
    (``Module.to`` would gather the shards on one device)."""

    def __init__(self, shards: list[nn.Module], bias: torch.Tensor | None) -> None:
        super().__init__()
        self.shards = nn.ModuleList(shards)
        self.devices = [next(s.parameters()).device for s in shards]
        self.bias = None if bias is None else nn.Parameter(bias.detach().to(self.devices[0]), requires_grad=False)
        self.quantized = shards[0].spec.quant_int8

    def forward(self, x: torch.Tensor | QuantizedRows) -> torch.Tensor:
        if self.quantized:
            return self._int8_forward(x)
        out = None
        for shard, device in zip(self.shards, self.devices):
            part = shard(x.to(device)).to(self.devices[0], torch.float32)
            out = part if out is None else out + part
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(x.dtype)

    def _int8_forward(self, x: QuantizedRows) -> torch.Tensor:
        first = self.devices[0]
        halves = [shard.row_amax(x.to(device)) for shard, device in zip(self.shards, self.devices)]
        amax = halves[0][1]
        for _, part in halves[1:]:
            amax = torch.maximum(amax, part.to(first))
        results = [shard.row_partial(rows, amax.to(device))
                   for shard, device, (rows, _) in zip(self.shards, self.devices, halves)]
        s_x = results[0][1]  # every shard's: one amax
        y = dequant_sum([partial.to(first) for partial, _ in results], s_x, self.shards[0].row_linear.qscale,
                        self.bias, x.dtype)
        return y.reshape(*x.shape[:-1], y.shape[-1])


class Block(nn.Module):
    def __init__(self, spec: ViTSpec) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(spec.dim, eps=spec.ln_eps)
        self.attn = Attention(spec)
        self.norm2 = nn.LayerNorm(spec.dim, eps=spec.ln_eps)
        self.mlp = Mlp(spec)
        self.quantized = spec.quant_int8
        if spec.layerscale:
            self.ls1 = nn.Parameter(torch.ones(spec.dim))
            self.ls2 = nn.Parameter(torch.ones(spec.dim))
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(self._normed(self.norm1, x))
        if self.ls1 is not None:
            h = h * self.ls1
        x = x + h
        h = self.mlp(self._normed(self.norm2, x))
        if self.ls2 is not None:
            h = h * self.ls2
        return x + h

    def _normed(self, norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor | QuantizedRows:
        """norm(x), or in the int8 serving mode its rows quantized in the same
        pass for the linears that read it (qkv; fc1, or fc_gate and fc_up)."""
        if not self.quantized:
            return norm(x)
        xq, s_x = layernorm_quantize_rows(x.reshape(-1, x.shape[-1]), norm.weight, norm.bias, norm.eps)
        return QuantizedRows(xq, s_x, tuple(x.shape), x.dtype)


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
        self.mlp = Mlp(replace(spec, quant_int8=False))  # the pooling head stays float

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
    ``running_var``; the int8 layout's ``kernel_q`` (in, out) → ``weight_q``
    (out, in) int8, contiguous; everything else as it is, in float32. The ViT
    and the other towers of the zoo (Swin, CLIP ModifiedResNet, CoCa, BEiT3)
    use it.

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
        leaf = path[-1]
        if leaf == "kernel_q":
            out[".".join(path[:-1] + ["weight_q"])] = torch.from_numpy(
                np.array(np.asarray(node, dtype=np.int8).T, order="C"))
            return
        arr = np.asarray(node, dtype=np.float32)
        if not arr.flags.writeable:  # a jax array's view: torch wants its own
            arr = arr.copy()
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            leaf = "weight"
        out[".".join(path[:-1] + [renames.get(leaf, leaf)])] = torch.from_numpy(arr)

    walk(params, [])
    return out


flax_vit_to_torch = flax_tree_to_torch
