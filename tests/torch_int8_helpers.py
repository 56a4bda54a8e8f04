"""Shared by the port's int8 tests (``tests/test_torch_int8*.py``): the tiny
ViT specs, their seeded Flax params and images, and the int8 model built
from a quantized tree."""

from __future__ import annotations

import numpy as np
import torch

from atlaspatch_tpu.models.encoders import vit as jvit
from atlaspatch_tpu_torch.models.encoders import vit as pvit
from atlaspatch_tpu_torch.models.encoders import zoo
from torch_port_helpers import shared_vit_params

TINY = dict(img_size=32, patch_size=16, dim=64, depth=2, heads=4)
SPECS = {
    "plain": {},
    "gated_mlp": dict(gated_mlp=True, mlp_hidden=96, layerscale=True),
    "rope": dict(pos_mode="rope", reg_tokens=2, swiglu=True, act="silu", mlp_hidden=48),
}
# The fused quantizers' CPU path against the unfused chain also at a CLIP-style tower (pre-LN,
# QuickGELU), which the JAX parity tests above leave to the quantizer-level tests below.
FUSED_SPECS = {**SPECS, "quick_gelu": dict(act="quick_gelu", pre_ln=True)}
PRE = dict(crop=32, resize=32, mode="square")
# The two engines round bfloat16 at other places (XLA rounds each op of the
# tanh GELU and of LayerNorm's normalization to bfloat16, torch each of its
# own ops once), and the int8 quantizers turn such last-bit differences into
# flipped int8 values. Over 9 seeded (spec, weights) pairs the port's int8
# path read per-row cosine >= 0.99864 against the JAX one, the size of each
# engine's own int8-against-float32 drift at this width (>= 0.99898).
BF16_INT8_COS = 0.998
# The fused quantizers' bar against the JAX op + quantizer (and, on the card,
# against their plain versions): xq elements differ by at most 1, in at most
# this share of them, and the row scales by at most 2^-8 relative.
FUSED_FLIP_SHARE = 1e-3
ACTS = ("gelu", "gelu_tanh", "quick_gelu", "silu", "relu")


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _images(n: int = 3, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


def _params(kw: dict, seed: int = 0) -> dict:
    return shared_vit_params(jvit.ViTSpec(**TINY, **kw), seed=seed)


def _int8_model(kw: dict, qtree: dict, **spec) -> pvit.ViT:
    model = pvit.ViT(pvit.ViTSpec(**TINY, **kw, quant_int8=True, **spec))
    model.load_state_dict(pvit.flax_vit_to_torch(qtree), strict=True)
    return model.eval()


def _rows(m: int, k: int, dtype, seed: int, scale: float = 2.0) -> torch.Tensor:
    x = np.random.default_rng(seed).normal(0.3, scale, (m, k)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _int8_widths(name: str) -> dict:
    """(K, N) of each int8 block linear of a zoo ViT, by Int8Linear name."""
    spec = zoo.ENTRIES[name].spec
    hidden = spec.hidden_dim
    mlp = ({"fc_gate": (spec.dim, hidden), "fc_up": (spec.dim, hidden)} if spec.gated_mlp
           else {"fc1": (spec.dim, 2 * hidden if spec.swiglu else hidden)})
    return {"qkv": (spec.dim, 3 * spec.dim), "proj": (spec.dim, spec.dim), **mlp, "fc2": (hidden, spec.dim)}
