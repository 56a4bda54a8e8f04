"""The port's ViT (atlaspatch_tpu_torch/models/encoders/vit.py) against the
Flax ViT of the JAX package, on the same params.

Each case builds one Flax param tree from a seed (the Flax initializers plus
N(0, 0.05) noise on every leaf, so zero-initialized tokens, biases and unit
LayerNorms carry values), runs it through ``ViT.apply`` in JAX and, through
``flax_vit_to_torch``, through the port on the CPU, on the same numpy images.
Tolerance: max-abs 1e-4 in float32. The specs are tiny and together cover
every ViTSpec feature; one case runs at vit_b_16's width with depth 2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlaspatch_tpu.models.encoders import convert as jax_convert
from atlaspatch_tpu.models.encoders.vit import ViT as JaxViT
from atlaspatch_tpu.models.encoders.vit import ViTSpec as JaxViTSpec
from atlaspatch_tpu_torch.models.encoders import convert as port_convert
from atlaspatch_tpu_torch.models.encoders.engine import init_random_weights_
from atlaspatch_tpu_torch.models.encoders.vit import ViT, ViTSpec, flax_vit_to_torch
from tests.upstream_layouts import torchvision_vit_sd
from torch_port_helpers import shared_vit_params as flax_params

TOL = 1e-4
TINY = dict(img_size=32, patch_size=8, dim=32, depth=2, heads=4)

CASES = {
    "cls_prefix_gelu": {},
    "registers_after_cls": dict(reg_tokens=2),
    "patches_layerscale_swiglu_silu": dict(reg_tokens=2, pos_mode="patches", layerscale=True,
                                           swiglu=True, act="silu", mlp_hidden=24),
    "all_mean": dict(reg_tokens=1, pos_mode="all", pool="mean"),
    "rope_gated_layerscale": dict(reg_tokens=2, pos_mode="rope", gated_mlp=True, layerscale=True,
                                  mlp_hidden=48, ln_eps=1e-5),
    "clip_pre_ln_quick_gelu_proj": dict(pre_ln=True, act="quick_gelu", patch_bias=False,
                                        proj_dim=16, ln_eps=1e-5),
    "siglip_map_gelu_tanh": dict(class_token=False, pos_mode="patches", pool="map",
                                 act="gelu_tanh", mlp_hidden=40),
    "cls_mean_concat_registers": dict(reg_tokens=4, pos_mode="patches", pool="cls_mean_concat"),
    "pool_none_relu": dict(pool="none", act="relu"),
    "no_cls_prefix_registers": dict(class_token=False, reg_tokens=2, pool="mean"),
    "no_final_norm_no_qkv_bias": dict(final_norm=False, qkv_bias=False, mlp_ratio=2.0),
}


def images(spec, n: int = 2, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, spec.img_size, spec.img_size, 3)).astype(np.float32)


def port_vit(spec_kw: dict, params: dict) -> ViT:
    model = ViT(ViTSpec(**spec_kw))
    model.load_state_dict(flax_vit_to_torch(params), strict=True)
    return model.eval()


def both(spec_kw: dict, x: np.ndarray, params: dict | None = None):
    jspec = JaxViTSpec(**spec_kw)
    params = flax_params(jspec) if params is None else params
    want = np.asarray(jax.jit(JaxViT(jspec).apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port_vit(spec_kw, params)(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_vit_matches_flax(case):
    kw = {**TINY, **CASES[case]}
    x = images(JaxViTSpec(**kw))
    got, want = both(kw, x)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


def test_gelu_tanh_switch_matches_flax(monkeypatch):
    kw = dict(TINY)
    x = images(JaxViTSpec(**kw))
    params = flax_params(JaxViTSpec(**kw))
    exact, _ = both(kw, x, params)
    monkeypatch.setenv("ATLASPATCH_GELU_TANH", "1")
    got, want = both(kw, x, params)
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - exact).max() > 1e-6  # the switch changed the activation


def test_vit_b_16_width_depth_2_matches_flax():
    kw = dict(img_size=224, patch_size=16, dim=768, depth=2, heads=12, ln_eps=1e-6)
    got, want = both(kw, images(JaxViTSpec(**kw), n=2))
    assert got.shape == (2, 768)
    assert np.abs(got - want).max() <= TOL


def test_spec_fields_match_the_jax_spec():
    assert [f.name for f in dataclasses.fields(ViTSpec)] == [f.name for f in dataclasses.fields(JaxViTSpec)]
    assert dataclasses.asdict(ViTSpec()) == dataclasses.asdict(JaxViTSpec())
    spec = ViTSpec(**TINY, reg_tokens=3, mlp_hidden=10)
    jspec = JaxViTSpec(**TINY, reg_tokens=3, mlp_hidden=10)
    assert (spec.tokens, spec.prefix_tokens, spec.hidden_dim) == (
        jspec.tokens, jspec.prefix_tokens, jspec.hidden_dim)


def test_state_dict_names_cover_the_flax_tree():
    kw = {**TINY, **CASES["rope_gated_layerscale"], "pool": "map"}
    params = flax_params(JaxViTSpec(**kw))
    converted = flax_vit_to_torch(params)
    model = ViT(ViTSpec(**kw))
    assert set(converted) == set(model.state_dict())
    for name, tensor in model.state_dict().items():
        assert converted[name].shape == tensor.shape, name


def test_torchvision_converter_matches_the_jax_converter():
    kw = dict(img_size=32, patch_size=8, dim=32, depth=2, heads=4, ln_eps=1e-6)
    jspec = JaxViTSpec(**kw)
    rng = np.random.default_rng(3)
    sd = {k: rng.normal(0.0, 0.2, v.shape).astype(np.float32)
          for k, v in torchvision_vit_sd(jspec, flax_params(jspec)).items()}
    torch_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    jax_tree = jax_convert.torchvision_vit_to_flax(sd, jspec)
    port_tree = port_convert.torchvision_vit_to_flax(torch_sd, ViTSpec(**kw))
    assert jax.tree.structure(jax_tree) == jax.tree.structure(port_tree)
    for a, b in zip(jax.tree.leaves(jax_tree), jax.tree.leaves(port_tree)):
        np.testing.assert_array_equal(a, b)
    model = ViT(ViTSpec(**kw))
    model.load_state_dict(port_convert.torchvision_vit_to_torch(torch_sd, ViTSpec(**kw)), strict=True)
    x = images(jspec)
    want = np.asarray(jax.jit(JaxViT(jspec).apply)({"params": jax_tree}, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= TOL


def test_random_init_is_deterministic_and_follows_the_flax_laws():
    spec = ViTSpec(**TINY, layerscale=True, pool="map")
    a, b = init_random_weights_(ViT(spec), seed=0), init_random_weights_(ViT(spec), seed=0)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    sd = a.state_dict()
    assert torch.equal(sd["cls_token"], torch.zeros_like(sd["cls_token"]))
    assert torch.equal(sd["blocks.0.ls1"], torch.ones(32))
    assert torch.equal(sd["blocks.0.norm1.weight"], torch.ones(32))
    w = sd["blocks.0.mlp.fc1.weight"]
    assert abs(w.std().item() - 32**-0.5) < 0.03 and w.abs().max() <= 2 * 32**-0.5 / 0.8796 + 1e-6


def test_int8_spec_raises():
    """The int8 ViT builds now (tests/test_torch_int8.py holds it); a float
    state_dict, without the quantized layout, is refused by its strict load."""
    params = flax_params(JaxViTSpec(**TINY))
    model = ViT(ViTSpec(**TINY, quant_int8=True))
    with pytest.raises(RuntimeError, match="weight_q"):
        model.load_state_dict(flax_vit_to_torch(params), strict=True)
