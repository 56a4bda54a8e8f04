"""The port's Swin/CHIEF, CLIP ModifiedResNet, CoCa/CONCH and BEiT3/MUSK towers
(atlaspatch_tpu_torch/models/encoders/{swin,clip_resnet,coca,beit3}.py)
against the JAX package's Flax towers.

The same Flax params, drawn with numpy from a seed for every leaf of the
Flax tree (so tokens, tables and biases carry values), go into both: the
JAX tower reads them as they are, the port through its ``flax_*_to_torch``. float32 on the CPU, max-abs within 1e-4. Miniature
widths cover each tower's features (shifted and unshifted windows, the
ConvStem and the plain patchify, strided and unstrided bottlenecks, one and
many pooler queries, the projection, MUSK's two scales); ``chief-ctranspath``
and ``clip_rn50`` also run at their real widths. transformers' ``SwinModel``
is a second oracle for the Swin blocks, through ``hf_swin_to_flax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlaspatch_tpu.models.encoders import beit3 as jax_beit3
from atlaspatch_tpu.models.encoders import clip_resnet as jax_clip_resnet
from atlaspatch_tpu.models.encoders import coca as jax_coca
from atlaspatch_tpu.models.encoders import swin as jax_swin
from atlaspatch_tpu.models.encoders.vit import ViTSpec as JaxViTSpec
from atlaspatch_tpu_torch.models.encoders import beit3, clip_resnet, coca, swin
from atlaspatch_tpu_torch.models.encoders.vit import ViTSpec

TOL = 1e-4  # float32, CPU, max-abs


def _shared_params(jax_model, size: int, seed: int, bn_scale: float = 1.0) -> dict:
    """Params of ``jax_model``'s tree (shapes by ``jax.eval_shape``, no init
    compiled) drawn with numpy from ``seed``: kernels N(0, 1/fan_in), LayerNorm
    and BatchNorm scales ``bn_scale`` · (1 + N(0, 0.05)), BatchNorm variances
    1 + |N(0, 0.05)|, every other leaf (biases, tokens, tables, queries,
    positional embeddings, BatchNorm means) N(0, 0.05)."""
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, size, size, 3))))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            value = rng.normal(0.0, np.prod(shape[:-1]) ** -0.5, shape)
        elif name == "scale":
            value = bn_scale * (1.0 + rng.normal(0.0, 0.05, shape))
        elif name == "var":
            value = 1.0 + np.abs(rng.normal(0.0, 0.05, shape))
        else:
            value = rng.normal(0.0, 0.05, shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _images(n: int, size: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _port(tower, spec, params, from_flax) -> torch.nn.Module:
    model = tower(spec)
    model.load_state_dict(from_flax(params), strict=True)
    return model.eval()


def _held(jax_model, port_model, params, x, apply=None):
    apply = jax.jit(apply or (lambda p, x: jax_model.apply({"params": p}, x)))
    want = np.asarray(apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port_model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= TOL, err
    return got


# --- Swin ---------------------------------------------------------------------------
SWIN_CASES = {
    # 64 px, patch 4, window 4: stages at 16, 8 (shifted windows), 4 (one
    # window, no shift) and 2 (window cut to the resolution)
    "conv_stem": dict(img_size=64, embed_dim=16, depths=(2, 2, 2, 2), heads=(1, 2, 2, 4), window=4),
    "patchify": dict(img_size=64, embed_dim=16, depths=(2, 2, 1), heads=(2, 2, 4), window=4,
                     conv_stem=False),
    "window7": dict(img_size=56, embed_dim=16, depths=(2, 2), heads=(2, 4), window=7),
}


@pytest.mark.parametrize("case", sorted(SWIN_CASES))
def test_swin_matches_flax(case):
    kw = SWIN_CASES[case]
    jax_model = jax_swin.SwinNet(jax_swin.SwinSpec(**kw))
    params = _shared_params(jax_model, kw["img_size"], seed=1)
    port = _port(swin.SwinNet, swin.SwinSpec(**kw), params, swin.flax_swin_to_torch)
    out = _held(jax_model, port, params, _images(3, kw["img_size"]))
    assert out.shape == (3, swin.SwinSpec(**kw).embedding_dim)


def test_chief_ctranspath_at_full_width():
    jax_model = jax_swin.SwinNet(jax_swin.SwinSpec())
    params = _shared_params(jax_model, 224, seed=2)
    port = _port(swin.SwinNet, swin.SwinSpec(), params, swin.flax_swin_to_torch)
    assert _held(jax_model, port, params, _images(2, 224)).shape == (2, 768)


def test_swin_geometry_is_the_jax_one():
    for window in (2, 4, 7):
        assert np.array_equal(swin._rel_pos_index(window), jax_swin._rel_pos_index(window))
    for res, window, shift in ((16, 4, 2), (8, 4, 2), (56, 7, 3), (28, 7, 3)):
        assert np.array_equal(swin._shift_attn_mask(res, window, shift),
                              jax_swin._shift_attn_mask(res, window, shift))
    assert swin._shift_attn_mask(8, 4, 0) is None


def test_swin_against_transformers_swin_model():
    """A second oracle: transformers' SwinModel through the port's HF converter."""
    transformers = pytest.importorskip("transformers")

    torch.manual_seed(11)
    cfg = transformers.SwinConfig(image_size=56, patch_size=4, embed_dim=16, depths=[2, 2],
                                  num_heads=[2, 4], window_size=7, mlp_ratio=4.0)
    oracle = transformers.SwinModel(cfg, add_pooling_layer=True).eval()
    spec = swin.SwinSpec(img_size=56, embed_dim=16, depths=(2, 2), heads=(2, 4), window=7,
                         conv_stem=False)
    model = swin.SwinNet(spec)
    model.load_state_dict(swin.flax_swin_to_torch(swin.hf_swin_to_flax(oracle.state_dict(), spec)), strict=True)
    x = _images(2, 56)
    with torch.no_grad():
        want = oracle(torch.from_numpy(x.transpose(0, 3, 1, 2))).pooler_output.numpy()
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


# --- CLIP ModifiedResNet --------------------------------------------------------------
# Random unit BatchNorm scales grow 16 residual blocks' activations to ~1e6,
# where float32 ulps exceed the gate; damped, they stay near unit scale.
RESIDUAL_BN_SCALE = 0.25
CLIP_RN_CASES = {
    "one_block": ((1, 1, 1, 1), 8, 16, 2, 64),
    "two_blocks": ((2, 1, 2, 1), 16, 24, 4, 64),
}


@pytest.mark.parametrize("case", sorted(CLIP_RN_CASES))
def test_clip_resnet_matches_flax(case):
    args = CLIP_RN_CASES[case]
    jax_model = jax_clip_resnet.ClipModifiedResNet(jax_clip_resnet.ClipResNetSpec(*args))
    params = _shared_params(jax_model, args[-1], seed=4, bn_scale=RESIDUAL_BN_SCALE)
    port = _port(clip_resnet.ClipModifiedResNet, clip_resnet.ClipResNetSpec(*args), params,
                 clip_resnet.flax_clip_resnet_to_torch)
    assert _held(jax_model, port, params, _images(3, args[-1])).shape == (3, args[2])


def test_clip_rn50_at_full_width():
    spec = clip_resnet.CLIP_RESNET_SPECS["clip_rn50"]
    jax_model = jax_clip_resnet.ClipModifiedResNet(jax_clip_resnet.CLIP_RESNET_SPECS["clip_rn50"])
    params = _shared_params(jax_model, 224, seed=5, bn_scale=RESIDUAL_BN_SCALE)
    port = _port(clip_resnet.ClipModifiedResNet, spec, params, clip_resnet.flax_clip_resnet_to_torch)
    assert _held(jax_model, port, params, _images(2, 224)).shape == (2, 1024)


def test_clip_resnet_specs_are_the_jax_ones():
    assert {k: dataclasses.asdict(v) for k, v in clip_resnet.CLIP_RESNET_SPECS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_clip_resnet.CLIP_RESNET_SPECS.items()}


# --- CoCa / CONCH / OmiCLIP -----------------------------------------------------------
_TRUNK = dict(img_size=32, patch_size=8, dim=32, depth=2, heads=4, pool="none", ln_eps=1e-5)
COCA_CASES = {
    # open_clip CoCa: pre-LN, no patch bias, no final norm, many queries
    "openclip": (dict(_TRUNK, pre_ln=True, patch_bias=False, final_norm=False), 4, 2, 24, False),
    "openclip_proj": (dict(_TRUNK, pre_ln=True, patch_bias=False, final_norm=False), 3, 4, 16, True),
    # CONCH: timm trunk with its final norm, one query
    "conch": (dict(_TRUNK, final_norm=True), 1, 2, 24, False),
}


@pytest.mark.parametrize("case", sorted(COCA_CASES))
def test_coca_matches_flax(case):
    trunk, n_queries, heads, out_dim, proj = COCA_CASES[case]

    def spec(mod, vit_spec):
        return mod.CoCaSpec(trunk=vit_spec(**trunk), n_queries=n_queries, pooler_heads=heads,
                            output_dim=out_dim, has_proj=proj)

    jax_model = jax_coca.CoCaVisual(spec(jax_coca, JaxViTSpec))
    params = _shared_params(jax_model, 32, seed=6)
    port = _port(coca.CoCaVisual, spec(coca, ViTSpec), params, coca.flax_coca_to_torch)
    assert _held(jax_model, port, params, _images(3, 32)).shape == (3, out_dim)


def test_coca_specs_are_the_jax_ones():
    for name in ("conch_v1_spec", "coca_vit_l14_spec"):
        assert dataclasses.asdict(getattr(coca, name)()) == dataclasses.asdict(getattr(jax_coca, name)())


# --- BEiT3 / MUSK ---------------------------------------------------------------------
BEIT3 = dict(img_size=32, patch_size=8, dim=32, depth=2, heads=4, ffn_dim=64)


@pytest.mark.parametrize("final_norm", [True, False])
def test_beit3_matches_flax(final_norm):
    jax_model = jax_beit3.Beit3Vision(jax_beit3.Beit3Spec(**BEIT3, final_norm=final_norm))
    params = _shared_params(jax_model, 32, seed=7)
    port = _port(beit3.Beit3Vision, beit3.Beit3Spec(**BEIT3, final_norm=final_norm), params,
                 beit3.flax_beit3_to_torch)
    assert _held(jax_model, port, params, _images(3, 32)).shape == (3, 32)


@pytest.mark.parametrize("scales", [(1, 2), (1, 2, 3)])
def test_musk_ms_aug_matches_flax(scales):
    """The multi-scale forward: bicubic ×s, chessboard crops, mean CLS per
    scale, scales concatenated (2048-d at MUSK's width for (1, 2))."""
    jax_model = jax_beit3.Beit3Vision(jax_beit3.Beit3Spec(**BEIT3))
    params = _shared_params(jax_model, 32, seed=8)
    spec = beit3.Beit3Spec(**BEIT3)
    port = beit3.MuskMsAug(spec, scales)
    port.load_state_dict(beit3.flax_beit3_to_torch(params), strict=True)
    out = _held(jax_model, port.eval(), params, _images(2, 32),
                apply=lambda p, x: jax_beit3.musk_ms_aug_apply(jax_model, p, x, scales))
    assert out.shape == (2, 32 * len(scales))


def test_musk_state_dict_is_the_towers():
    spec = beit3.Beit3Spec(**BEIT3)
    assert list(beit3.MuskMsAug(spec).state_dict()) == list(beit3.Beit3Vision(spec).state_dict())
    assert beit3.MuskMsAug(spec).scales == (1, 2)
