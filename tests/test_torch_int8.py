"""The int8 (W8A8) serving mode of the port's ViT against the JAX package's, on the CPU.

Inputs and weights come from numpy with a seed (``shared_vit_params``), and
both packages run them: the JAX side as ``tests/test_int8_mode.py`` runs it.

  * ``quantize_vit_params``: the port's equals the JAX one (int8 and scales
    bit for bit); ``quantize_vit_state_dict`` equals it after conversion; the
    layout loads strictly into the int8 ViT and equals the JAX int8 model's
    init layout; dequantized weights within qscale / 2; non-block layers
    alone.
  * ``Int8Linear`` against ``Int8Dense`` on the same int8 weights, float32
    and bfloat16 inputs: xq, s_x, the int32 sum and the output equal
    (``ops/int8.py``'s plain versions, which the CUDA kernels equal bit for
    bit on the card), with a row crafted to hit exact .5 ties.
  * the ``quant_int8_attn`` branch: its int32 products equal, its output
    within 1e-6 (the softmaxes differ in the last bit).
  * the whole int8 ViT on the same quantized tree, float32 activations:
    max-abs within 1e-3 of the feature's largest magnitude (a quantizer input
    off by one ulp may flip an int8 value; the flips are counted); through
    both engines' bfloat16 int8 path: per-row cosine >= BF16_INT8_COS.
  * the quantizer fused with the op before it (``layernorm_quantize_rows``,
    ``act_quantize_rows``, ``quantize_heads``): each plain version equals the
    unfused chain bit for bit in float32 and bfloat16, and, in float32,
    ``nn.LayerNorm`` / the MLP's ``_act`` followed by ``Int8Dense``'s
    quantizer within FUSED_FLIP_SHARE flipped xq elements of at most 1 and
    scales within 2^-8; the int8 ViT through the fused path equals the
    unfused chain bit for bit on the CPU; a gated MLP quantizes its input
    once; the refusals.
  * the GELU switch, the registry, the fallback of other families, the
    drift contract (int8 against float32 cosine > 0.98) and the engine's
    cast, which keeps ``qscale`` float32 and ``weight_q`` int8.
"""

import re
from pathlib import Path


import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlaspatch_tpu.models.encoders import vit as jvit
from atlaspatch_tpu.models.encoders.engine import JaxFeatureExtractor
from atlaspatch_tpu.models.encoders.engine import PreprocessSpec as JaxPreprocessSpec
from atlaspatch_tpu_torch.models.encoders import vit as pvit
from atlaspatch_tpu_torch.models.encoders import zoo
from atlaspatch_tpu_torch.models.encoders.engine import PreprocessSpec, TorchFeatureExtractor
from atlaspatch_tpu_torch.ops import int8 as I
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


# --- quantize_vit_params ---------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(SPECS))
def test_quantize_vit_params_matches_jax(case):
    params = _params(SPECS[case])
    want, got = jvit.quantize_vit_params(params), pvit.quantize_vit_params(params)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for (path, a), (_, b) in zip(_leaf_paths(want), _leaf_paths(got)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("case", sorted(SPECS))
def test_state_dict_twin_equals_the_tree_quantizer(case):
    params = _params(SPECS[case])
    want = pvit.flax_vit_to_torch(jvit.quantize_vit_params(params))
    got = pvit.quantize_vit_state_dict(pvit.flax_vit_to_torch(params))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        assert torch.equal(got[key], value), key
        if key.endswith("weight_q"):
            assert value.dtype == torch.int8 and value.is_contiguous()
    model = pvit.ViT(pvit.ViTSpec(**TINY, **SPECS[case], quant_int8=True))
    model.load_state_dict(got, strict=True)


def test_int8_layout_matches_model_init():
    """Mirrors tests/test_int8_mode.py::test_int8_layout_matches_model_init:
    the converted tree has the JAX int8 model's layout, and it loads strictly
    into the port's int8 ViT, whose state_dict names and shapes it fills."""
    jspec = jvit.ViTSpec(**TINY)
    params = _params({})
    qinit = jvit.ViT(dataclasses.replace(jspec, quant_int8=True)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    qconv = pvit.quantize_vit_params(params)
    assert {p for p, _ in _leaf_paths(qinit)} == {p for p, _ in _leaf_paths(qconv)}
    state = pvit.flax_vit_to_torch(qconv)
    model = pvit.ViT(pvit.ViTSpec(**TINY, quant_int8=True))
    assert {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in state.items()}
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = model(torch.zeros(1, 32, 32, 3, dtype=torch.bfloat16).float())
    assert torch.isfinite(out).all()


def test_quantize_roundtrip_error_bound():
    params = _params({})
    state = pvit.flax_vit_to_torch(params)
    qstate = pvit.quantize_vit_state_dict(state)
    checked = 0
    for key, wq in qstate.items():
        if key.endswith("weight_q"):
            prefix = key[: -len("weight_q")]
            scale = qstate[prefix + "qscale"]
            deq = wq.float() * scale[:, None]
            assert ((deq - state[prefix + "weight"]).abs() <= scale[:, None] / 2 + 1e-7).all(), key
            checked += 1
    assert checked == 2 * 4


def test_quantizer_leaves_non_block_layers_alone():
    kw = dict(pool="map", proj_dim=32)
    params = shared_vit_params(jvit.ViTSpec(**{**TINY, "depth": 1}, **kw))
    state = pvit.flax_vit_to_torch(params)
    qstate = pvit.quantize_vit_state_dict(state)
    for key in qstate:
        if key.endswith(("weight_q", "qscale")):
            assert key.startswith("blocks."), key
    for key in ("head.mlp.fc1.weight", "head.q_proj.weight", "proj.weight", "patch_embed.weight"):
        assert torch.equal(qstate[key], state[key])
    model = pvit.ViT(pvit.ViTSpec(**{**TINY, "depth": 1}, **kw, quant_int8=True))
    model.load_state_dict(qstate, strict=True)
    assert isinstance(model.head.mlp.fc1, torch.nn.Linear)
    assert isinstance(model.blocks[0].mlp.fc1, pvit.Int8Linear)


# --- Int8Linear against Int8Dense --------------------------------------------------------
def _dense_case(K: int, N: int, seed: int):
    rng = np.random.default_rng(seed)
    kernel_q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    qscale = (rng.uniform(0.5, 2.0, N) / 127.0).astype(np.float32)
    bias = rng.normal(0.0, 0.5, N).astype(np.float32)
    return kernel_q, qscale, bias


def _jax_dense_parts(x, kernel_q, qscale, bias):
    """xq, s_x, the int32 sum and the output of Int8Dense, its own lines
    (vit.py:142-156) run on its inputs."""
    xf = x.astype(jnp.float32)
    xq, s_x = jvit._q8_dyn(xf, axis=-1)
    acc = jax.lax.dot_general(xq, jnp.asarray(kernel_q), (((xq.ndim - 1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    y = jvit.Int8Dense(kernel_q.shape[1]).apply(
        {"params": {"kernel_q": kernel_q, "qscale": qscale, "bias": bias}}, x)
    return np.asarray(xq), np.asarray(s_x)[..., 0], np.asarray(acc), np.asarray(y.astype(jnp.float32))


def _port_linear(kernel_q, qscale, bias, dtype):
    layer = pvit.Int8Linear(*kernel_q.shape)
    layer.weight_q.copy_(torch.from_numpy(np.ascontiguousarray(kernel_q.T)))
    layer.qscale.copy_(torch.from_numpy(qscale))
    layer.bias = torch.nn.Parameter(torch.from_numpy(np.array(bias, np.float32)).to(dtype))
    return layer


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(48, 40), (64, 192), (37, 5)])
def test_int8_linear_matches_int8_dense(dtype, K, N):
    kernel_q, qscale, bias = _dense_case(K, N, seed=K + N)
    x = np.random.default_rng(K).normal(0.0, 2.0, (2, 7, K)).astype(np.float32)
    x[0, 0, :4] = [127.0, 2.5, -3.5, 0.5]  # amax 127 -> s = 1: ties round to 2, -4 and 0
    x[0, 0, 4:] = 0.0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    bj = jnp.asarray(bias).astype(jdt)  # the engine casts the bias to the activations' dtype
    want_xq, want_s, want_acc, want_y = _jax_dense_parts(xj, kernel_q, qscale, bj)
    assert list(want_xq[0, 0, :4]) == [127, 2, -4, 0]

    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    xq, s_x = I.quantize_rows(xt.reshape(-1, K))
    np.testing.assert_array_equal(xq.numpy(), want_xq.reshape(-1, K))
    np.testing.assert_array_equal(s_x.numpy(), want_s.reshape(-1))
    acc = I.int_product("mk,nk->mn", xq, torch.from_numpy(np.ascontiguousarray(kernel_q.T)))
    np.testing.assert_array_equal(acc.numpy(), want_acc.reshape(-1, N))
    layer = _port_linear(kernel_q, qscale, np.asarray(bj.astype(jnp.float32)), tdt)
    with torch.no_grad():
        got = layer(xt)
    assert got.dtype == tdt and got.shape == (2, 7, N)
    np.testing.assert_array_equal(got.float().numpy(), want_y)


def test_int8_linear_without_bias_and_refusals():
    kernel_q, qscale, _ = _dense_case(32, 16, seed=1)
    x = np.random.default_rng(1).normal(size=(3, 32)).astype(np.float32)
    want = jvit.Int8Dense(16, use_bias=False).apply({"params": {"kernel_q": kernel_q, "qscale": qscale}},
                                                    jnp.asarray(x))
    xq, s_x = I.quantize_rows(torch.from_numpy(x))
    got = I.int8_linear(xq, s_x, torch.from_numpy(np.ascontiguousarray(kernel_q.T)), torch.from_numpy(qscale),
                        None, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="2-D"):
        I.quantize_rows(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        I.quantize_rows(torch.zeros(2, 4, dtype=torch.float16))
    with pytest.raises(ValueError, match="shapes do not match"):
        I.int8_linear(xq, s_x, torch.zeros(16, 31, dtype=torch.int8), torch.from_numpy(qscale), None, torch.float32)
    with pytest.raises(ValueError, match="float32 scales"):
        I.int8_linear(xq, s_x.bfloat16(), torch.from_numpy(np.ascontiguousarray(kernel_q.T)),
                      torch.from_numpy(qscale), None, torch.float32)


def test_plain_versions_run_on_the_cpu_without_a_launch():
    I.reset_launch_counts()
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(5, 48)).astype(np.float32))
    xq, s_x = I.quantize_rows(x)
    I.int8_linear(xq, s_x, torch.ones(8, 48, dtype=torch.int8), torch.ones(8), torch.zeros(8), torch.bfloat16)
    assert I.quantize_rows.launches == 0 and I.int8_linear.launches == 0
    assert not I.int8_linear.variant_launches


# --- tensor-parallel int8's halves: a row split over shards --------------------------------
def _cuts(k: int, parts: int) -> list[slice]:
    edges = [k * i // parts for i in range(parts + 1)]
    return [slice(a, b) for a, b in zip(edges, edges[1:])]


@pytest.mark.parametrize("parts", [2, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(48, 40), (64, 192), (37, 5)])
def test_split_row_equals_int8_dense_on_the_whole_row(dtype, K, N, parts):
    """A row-parallel Int8Dense as the JAX program computes it under the TP
    plan, against the port's halves on K cut in ``parts``: the slices'
    abs-maxes maxed equal the whole row's (``row_amax_plain``); each slice
    quantized with it (``quantize_rows_plain(amax=)``) equals the whole row's
    xq there and its s_x; the slices' int32 products
    (``int8_linear_s32_plain``) sum to the whole dot_general's; and
    ``dequant_sum_plain`` of them equals Int8Dense's output, bit for bit."""
    kernel_q, qscale, bias = _dense_case(K, N, seed=K * N)
    x = np.random.default_rng(K + parts).normal(0.0, 2.0, (2, 7, K)).astype(np.float32)
    x[0, 0, :4] = [127.0, 2.5, -3.5, 0.5]  # ties, and the row's max in the first slice
    x[0, 0, 4:] = 0.0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    bj = jnp.asarray(bias).astype(jdt)
    want_xq, want_s, want_acc, want_y = _jax_dense_parts(xj, kernel_q, qscale, bj)
    rows = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt).reshape(-1, K)
    w = torch.from_numpy(np.ascontiguousarray(kernel_q.T))
    cuts = _cuts(K, parts)
    amax = torch.stack([I.row_amax_plain(rows[:, c]) for c in cuts]).amax(dim=0)
    np.testing.assert_array_equal(amax.numpy(), np.abs(np.asarray(xj.astype(jnp.float32))).max(-1).reshape(-1))
    slices = [I.quantize_rows_plain(rows[:, c], amax) for c in cuts]
    np.testing.assert_array_equal(torch.cat([q for q, _ in slices], dim=1).numpy(), want_xq.reshape(-1, K))
    for _, s_x in slices:
        np.testing.assert_array_equal(s_x.numpy(), want_s.reshape(-1))
    partials = [I.int8_linear_s32_plain(q, w[:, c].contiguous()) for (q, _), c in zip(slices, cuts)]
    assert all(p.dtype == torch.int32 for p in partials)
    np.testing.assert_array_equal(sum(p.numpy() for p in partials), want_acc.reshape(-1, N))
    bias_t = torch.from_numpy(np.asarray(bj.astype(jnp.float32))).to(tdt)
    got = I.dequant_sum_plain(partials, slices[0][1], torch.from_numpy(qscale), bias_t, tdt)
    assert got.dtype == tdt and got.shape == (14, N)
    np.testing.assert_array_equal(got.float().numpy(), want_y.reshape(-1, N))
    # the wrappers run the same plain versions on CPU tensors, and launch nothing
    I.reset_launch_counts()
    assert torch.equal(I.dequant_sum(partials, slices[0][1], torch.from_numpy(qscale), bias_t, tdt), got)
    assert torch.equal(I.int8_linear_s32(slices[0][0], w[:, cuts[0]].contiguous()), partials[0])
    assert torch.equal(I.row_amax(rows[:, cuts[0]]), I.row_amax_plain(rows[:, cuts[0]]))
    assert I.quantize_rows.launches == I.int8_linear.launches == I.dequant_sum.launches == 0


@pytest.mark.parametrize("gate", [None, "swiglu", "gated"])
@pytest.mark.parametrize("act", ACTS)
def test_split_act_quantizer_matches_the_whole_row(act, gate):
    """The activation before a row-parallel fc2, its hidden units split over
    two shards, each holding its operands as its own linears leave them: the
    halves' abs-maxes (``act_row_amax``) maxed are the JAX MLP's row abs-max
    (within 2^-8, the bar of the fused quantizers), and each half quantized
    with it (``act_quantize_rows(amax=)``) gives the bytes and the scale of
    the one-pass quantizer over the whole row of those activation values, bit
    for bit. They are the whole row's own values but where ATen's CPU kernels
    round a strided row's vector tail otherwise: a SwiGLU half's row of 48
    values, no multiple of their 32-value vectors, for GELU, tanh GELU and
    SiLU here. The card's prologue computes each value alike wherever it
    lies."""
    rng = np.random.default_rng(4)
    a = rng.normal(0.0, 2.0, (64, 96)).astype(np.float32)
    b = rng.normal(0.0, 2.0, (64, 96)).astype(np.float32) if gate else None
    h = jvit._act(act)(jnp.asarray(a))
    jax_amax = np.abs(np.asarray(h if b is None else h * jnp.asarray(b))).max(-1)
    if gate == "swiglu":
        ta, tb = torch.from_numpy(np.concatenate([a, b], axis=1)).chunk(2, dim=-1)
    else:
        ta, tb = torch.from_numpy(a), None if b is None else torch.from_numpy(b)
    halves = [(ta[:, c].contiguous(), None if tb is None else tb[:, c].contiguous()) for c in _cuts(96, 2)]
    if gate == "swiglu":
        halves = [torch.cat(h, dim=1).chunk(2, dim=-1) for h in halves]
    values = torch.cat([I._act_rows(x, act, y) for x, y in halves], dim=1)
    moved = int((values != I._act_rows(ta, act, tb)).sum())
    print(f"{act} {gate}: {moved} of {values.numel()} activation values rounded otherwise on the halves")
    assert moved == 0 or gate == "swiglu"
    whole = I.quantize_rows_plain(values)
    amax = torch.maximum(*(I.act_row_amax(x, act, y) for x, y in halves))
    assert np.abs(amax.numpy() / jax_amax - 1).max() <= 2.0**-8
    got = [I.act_quantize_rows(x, act, y, amax) for x, y in halves]
    assert torch.equal(torch.cat([q for q, _ in got], dim=1), whole[0])
    assert all(torch.equal(s_x, whole[1]) for _, s_x in got)


def test_split_heads_quantizer_matches_the_whole_rows():
    """The attention's (B, T, H, D) output before a row-parallel proj, its
    heads split over two shards: heads_amax of each maxed, then
    quantize_heads with it, give the whole rows' xq and s_x."""
    attn = torch.softmax(_rows(2 * 4 * 5, 5, torch.bfloat16, seed=9).reshape(2, 4, 5, 5), dim=-1)
    v = _rows(2 * 5 * 4, 8, torch.bfloat16, seed=10).reshape(2, 5, 4, 8)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    whole = I.quantize_heads(out)
    amax = torch.maximum(I.heads_amax(out[:, :, :2]), I.heads_amax(out[:, :, 2:]))
    assert torch.equal(amax, out.float().abs().amax(dim=(2, 3)).reshape(-1))
    got = [I.quantize_heads(out[:, :, h], amax) for h in (slice(0, 2), slice(2, 4))]
    assert torch.equal(torch.cat([q for q, _ in got], dim=1), whole[0])
    assert all(torch.equal(s_x, whole[1]) for _, s_x in got)


def test_split_quantizers_refuse_what_they_do_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match=r"takes a \(4,\) torch.float32 amax"):
        I.quantize_rows(x, torch.zeros(3))
    with pytest.raises(ValueError, match=r"takes a \(4,\) torch.float32 amax"):
        I.act_quantize_rows(x, "silu", None, torch.zeros(4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=r"takes a \(6,\) torch.float32 amax"):
        I.quantize_heads(torch.zeros(2, 3, 2, 4), torch.zeros(4))
    with pytest.raises(ValueError, match="no activation 'tanh'"):
        I.act_row_amax(x, "tanh")
    part = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="1 to 8 partials"):
        I.dequant_sum([], torch.ones(4), torch.ones(8), None, torch.float32)
    with pytest.raises(ValueError, match="int32 partials of one shape"):
        I.dequant_sum([part, part.float()], torch.ones(4), torch.ones(8), None, torch.float32)
    with pytest.raises(ValueError, match=r"\(4,\) and \(8,\) float32 scales"):
        I.dequant_sum([part], torch.ones(4), torch.ones(7), None, torch.float32)
    with pytest.raises(ValueError, match="writes float32 or bfloat16"):
        I.dequant_sum([part], torch.ones(4), torch.ones(8), None, torch.int32)
    with pytest.raises(ValueError, match="shapes do not match"):
        I.int8_linear_s32(torch.zeros(4, 8, dtype=torch.int8), torch.zeros(3, 7, dtype=torch.int8))


def test_quant_modes_match_the_kernel_source():
    src = (Path(I.__file__).parents[1] / "csrc" / "int8_linear.cu").read_text()
    modes = re.search(r"enum Mode : int \{([^}]*)\}", src).group(1)
    assert [m.strip() for m in modes.split(",")] == ["kOnePass", "kAmaxOnly", "kGivenAmax"]
    assert I.QUANT_MODES == ("one_pass", "amax_only", "given_amax")
    outs = re.search(r"enum OutType : int \{([^}]*)\}", src).group(1)
    assert [m.strip() for m in outs.split(",")] == ["kOutF32", "kOutBF16", "kOutS32"]
    assert list(I._OUT_CODES) == [torch.float32, torch.bfloat16, torch.int32]
    assert f"kMaxPartials = {I.MAX_PARTIALS};" in src


# --- the quantizer fused with the op before it -------------------------------------------
def _rows(m: int, k: int, dtype, seed: int, scale: float = 2.0) -> torch.Tensor:
    x = np.random.default_rng(seed).normal(0.3, scale, (m, k)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _assert_fused_bar(got, want, what):
    """xq within 1 in at most FUSED_FLIP_SHARE of the elements, s_x within 2^-8."""
    (xq, s_x), (want_xq, want_s) = got, want
    diff = (xq.int() - want_xq.int()).abs()
    share = (diff > 0).float().mean().item()
    rel = ((s_x - want_s).abs() / want_s).max().item()
    print(f"{what}: {int((diff > 0).sum())} of {diff.numel()} xq flipped ({share:.2e}), s_x rel {rel:.2e}")
    assert diff.max().item() <= 1 and share <= FUSED_FLIP_SHARE and rel <= 2.0**-8, what


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [48, 64, 1024])
def test_layernorm_plain_version_is_the_unfused_chain(dtype, k):
    x = _rows(37, k, dtype, seed=k)
    norm = torch.nn.LayerNorm(k, eps=1e-6).to(dtype)
    with torch.no_grad():
        norm.weight.copy_(_rows(1, k, dtype, seed=1, scale=0.5)[0] + 1)
        norm.bias.copy_(_rows(1, k, dtype, seed=2, scale=0.5)[0])
        want = I.quantize_rows_plain(norm(x))
    for got in (I.layernorm_quantize_rows_plain(x, norm.weight, norm.bias, norm.eps),
                I.layernorm_quantize_rows(x, norm.weight, norm.bias, norm.eps)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate", [None, "swiglu", "gated"])
@pytest.mark.parametrize("act", ACTS)
def test_act_plain_version_is_the_unfused_chain(act, gate, dtype):
    """What Mlp.forward ran before the fusion: act(fc1(x)), act(x1) * x2 of
    one fc1 output's halves, act(fc_gate(x)) * fc_up(x)."""
    fn = pvit._act(act)
    h = _rows(37, 2 * 72 if gate == "swiglu" else 72, dtype, seed=5)
    if gate == "swiglu":
        a, b = h.chunk(2, dim=-1)
    else:
        a, b = h, (_rows(37, 72, dtype, seed=6) if gate == "gated" else None)
    want = I.quantize_rows_plain(fn(a) if b is None else fn(a) * b)
    for got in (I.act_quantize_rows_plain(a, act, b), I.act_quantize_rows(a, act, b)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_quantize_heads_is_the_reshaped_rows():
    """The attention's output as its einsum leaves it: (B, T, H, D), not
    contiguous, quantized as the (B T, H D) rows of its reshape."""
    attn = torch.softmax(_rows(2 * 4 * 5, 5, torch.float32, seed=7).reshape(2, 4, 5, 5), dim=-1)
    v = _rows(2 * 5 * 4, 8, torch.float32, seed=8).reshape(2, 5, 4, 8)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    assert not out.is_contiguous()
    want = I.quantize_rows_plain(out.reshape(10, 32))
    got = I.quantize_heads(out)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [48, 1024])
def test_layernorm_quantizer_matches_jax_layernorm_and_int8_dense(k):
    """float32 rows from numpy: the plain version against the JAX
    ``nn.LayerNorm`` followed by ``Int8Dense``'s quantizer."""
    rng = np.random.default_rng(k)
    x = rng.normal(0.3, 2.0, (64, k)).astype(np.float32)
    scale, bias = (1 + rng.normal(0, 0.5, k)).astype(np.float32), rng.normal(0, 0.5, k).astype(np.float32)
    y = fnn.LayerNorm(epsilon=1e-6).apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    want = jvit._q8_dyn(y, axis=-1)
    got = I.layernorm_quantize_rows_plain(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 1e-6)
    _assert_fused_bar(got, (torch.from_numpy(np.asarray(want[0])), torch.from_numpy(np.asarray(want[1])[:, 0])),
                      f"layernorm K={k}")


@pytest.mark.parametrize("gate", [None, "swiglu", "gated"])
@pytest.mark.parametrize("act", ACTS)
def test_act_quantizer_matches_jax_mlp_and_int8_dense(act, gate):
    """float32 rows from numpy: the plain version against the JAX MLP's
    ``_act`` (then ``* b``) followed by ``Int8Dense``'s quantizer."""
    rng = np.random.default_rng(3)
    a = rng.normal(0.0, 2.0, (64, 96)).astype(np.float32)
    b = rng.normal(0.0, 2.0, (64, 96)).astype(np.float32) if gate else None
    h = jvit._act(act)(jnp.asarray(a))
    want = jvit._q8_dyn(h if b is None else h * jnp.asarray(b), axis=-1)
    if gate == "swiglu":  # the two halves of one fc1 output
        both = torch.from_numpy(np.concatenate([a, b], axis=1))
        ta, tb = both.chunk(2, dim=-1)
    else:
        ta, tb = torch.from_numpy(a), None if b is None else torch.from_numpy(b)
    got = I.act_quantize_rows_plain(ta, act, tb)
    _assert_fused_bar(got, (torch.from_numpy(np.asarray(want[0])), torch.from_numpy(np.asarray(want[1])[:, 0])),
                      f"{act} {gate}")


def _unfused_forward(model: pvit.ViT, x: torch.Tensor) -> torch.Tensor:
    """The int8 ViT as the port ran it before the fusion: each LayerNorm and
    activation stored, the attention's output reshaped, every Int8Linear fed
    a plain tensor."""
    s = model.spec

    def block(blk, x):
        h = blk.norm1(x)
        B, T, _ = h.shape
        q, k, v = blk.attn.qkv(h).reshape(B, T, 3, s.heads, s.dim // s.heads).unbind(2)
        if s.pos_mode == "rope":
            cos = blk.attn.rope_cos.to(q.dtype)[None, :, None, :]
            sin = blk.attn.rope_sin.to(q.dtype)[None, :, None, :]
            n = T - cos.shape[1]
            qp, kp = q[:, n:], k[:, n:]
            q = torch.cat([q[:, :n], qp * cos + pvit._rotate_half(qp) * sin], dim=1)
            k = torch.cat([k[:, :n], kp * cos + pvit._rotate_half(kp) * sin], dim=1)
        out = pvit._softmax_attention(q, k, v, "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd")
        h = blk.attn.proj(out.reshape(B, T, s.dim))
        x = x + (h if blk.ls1 is None else h * blk.ls1)
        h, mlp = blk.norm2(x), blk.mlp
        if s.gated_mlp:
            h = mlp.act(mlp.fc_gate(h)) * mlp.fc_up(h)
        elif s.swiglu:
            x1, x2 = mlp.fc1(h).chunk(2, dim=-1)
            h = mlp.act(x1) * x2
        else:
            h = mlp.act(mlp.fc1(h))
        h = mlp.fc2(h)
        return x + (h if blk.ls2 is None else h * blk.ls2)

    blocks = model.blocks
    features = {}
    hook = blocks[0].register_forward_pre_hook(lambda mod, args: features.setdefault("in", args[0]))
    model(x)
    hook.remove()
    y = features["in"]
    for blk in blocks:
        y = block(blk, y)
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FUSED_SPECS))
def test_fused_blocks_equal_the_unfused_chain_on_the_cpu(case, dtype):
    """On the CPU the fused quantizers run the ops the port ran before, so
    the int8 blocks' output is unchanged bit for bit."""
    kw = FUSED_SPECS[case]
    model = _int8_model(kw, jvit.quantize_vit_params(_params(kw, seed=9)))
    model.to(dtype)
    for mod in model.modules():
        if isinstance(mod, pvit.Int8Linear):
            mod.qscale.data = mod.qscale.data.float()
    x = torch.from_numpy(_images(seed=9)).to(dtype)
    outputs = []
    hook = model.blocks[-1].register_forward_hook(lambda mod, args, out: outputs.append(out))
    with torch.no_grad():
        model(x)
        want = _unfused_forward(model, x)
    hook.remove()
    assert outputs[0].dtype == dtype and torch.equal(outputs[0], want)


def _counting(monkeypatch, names):
    calls = {name: 0 for name in names}
    for name in names:
        fn = getattr(pvit, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(pvit, name, counted)
    return calls


@pytest.mark.parametrize("case", sorted(FUSED_SPECS))
def test_quantizers_per_block_by_prologue(case, monkeypatch):
    """Per block: two layernorm quantizers (norm1 → qkv; norm2 → fc1, or
    shared by fc_gate and fc_up), one activation quantizer (→ fc2), one of
    the attention's output (→ proj), and no quantize_rows of a plain
    tensor."""
    kw = FUSED_SPECS[case]
    model = _int8_model(kw, jvit.quantize_vit_params(_params(kw)))
    calls = _counting(monkeypatch, ("layernorm_quantize_rows", "act_quantize_rows", "quantize_heads",
                                    "quantize_rows"))
    with torch.no_grad():
        model(torch.from_numpy(_images()))
    depth = TINY["depth"]
    assert calls == {"layernorm_quantize_rows": 2 * depth, "act_quantize_rows": depth, "quantize_heads": depth,
                     "quantize_rows": 0}


def test_prologue_codes_match_the_kernel_source():
    """ops/int8.py::PROLOGUES lists the C enum's prologues in its order."""
    src = (Path(I.__file__).parents[1] / "csrc" / "int8_linear.cu").read_text()
    enum = re.search(r"enum Prologue : int \{([^}]*)\}", src).group(1)
    assert [n.strip()[1:].lower() for n in enum.split(",")] == [n.replace("_", "") for n in I.PROLOGUES]


def test_fused_quantizers_refuse_what_they_do_not_take():
    x = torch.zeros(4, 8)
    w, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        I.layernorm_quantize_rows(x.half(), w.half(), b.half(), 1e-6)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        I.act_quantize_rows(x.half(), "gelu")
    with pytest.raises(ValueError, match="2-D"):
        I.act_quantize_rows(torch.zeros(2, 4, 8), "gelu")
    with pytest.raises(ValueError, match="4-D"):
        I.quantize_heads(x)
    with pytest.raises(ValueError, match="empty"):
        I.layernorm_quantize_rows(torch.zeros(0, 8), w, b, 1e-6)
    with pytest.raises(ValueError, match="empty"):
        I.act_quantize_rows(torch.zeros(0, 8), "silu")
    with pytest.raises(ValueError, match=r"\(8,\) torch.float32 weight"):
        I.layernorm_quantize_rows(x, torch.ones(7), b, 1e-6)
    with pytest.raises(ValueError, match=r"\(8,\) torch.float32 bias"):
        I.layernorm_quantize_rows(x, w, b.bfloat16(), 1e-6)
    with pytest.raises(ValueError, match=r"\(8,\) torch.float32 weight"):
        I.layernorm_quantize_rows(x, None, b, 1e-6)
    with pytest.raises(ValueError, match="no activation 'tanh'"):
        I.act_quantize_rows(x, "tanh")
    with pytest.raises(ValueError, match="takes b like a"):
        I.act_quantize_rows(x, "silu", torch.zeros(4, 9))
    with pytest.raises(ValueError, match="takes b like a"):
        I.act_quantize_rows(x, "silu", x.bfloat16())


def test_rows_longer_than_the_registers_hold_are_refused_before_a_launch():
    """The kernel holds a row in registers (at most QUANT_MAX_K values): a
    longer one is refused before the library is touched."""
    I.reset_launch_counts()
    x = torch.zeros(2, I.QUANT_MAX_K + 16)
    with pytest.raises(ValueError, match=f"at most {I.QUANT_MAX_K} values"):
        I._launch_quantize("identity", x, (0, x.stride(0), 2, 0, x.shape[1]))
    assert I.quantize_rows.launches == 0 and not I.quantize_rows.prologue_launches


# --- which int8_linear_s8 body a shape takes ----------------------------------------------
def _int8_widths(name: str) -> dict:
    """(K, N) of each int8 block linear of a zoo ViT, by Int8Linear name."""
    spec = zoo.ENTRIES[name].spec
    hidden = spec.hidden_dim
    mlp = ({"fc_gate": (spec.dim, hidden), "fc_up": (spec.dim, hidden)} if spec.gated_mlp
           else {"fc1": (spec.dim, 2 * hidden if spec.swiglu else hidden)})
    return {"qkv": (spec.dim, 3 * spec.dim), "proj": (spec.dim, spec.dim), **mlp, "fc2": (hidden, spec.dim)}


@pytest.mark.parametrize("name,layer,want", [
    *[("vit_l_16", layer, "wgmma") for layer in ("qkv", "proj", "fc1", "fc2")],
    *[("medsiglip", layer, "wgmma") for layer in ("qkv", "proj", "fc1", "fc2")],
    *[("uni_v1", layer, "wgmma") for layer in ("qkv", "proj", "fc1", "fc2")],
    ("virchow_v1", "qkv", "wgmma"), ("virchow_v1", "fc1", "wgmma"),
    ("virchow_v1", "fc2", "mma"), ("virchow_v2", "fc2", "mma"),
])
def test_linear_variant_over_the_zoo_int8_widths(name, layer, want):
    """The wgmma body takes K a multiple of 16 (a TMA map's row stride):
    every vit_l_16, medsiglip and uni linear in bfloat16, the int8 engine's
    dtype; virchow's fc2 reads the SwiGLU half-width, K = 3,416 = 16 x
    213.5, and stays on mma.sync, as does every float32 output."""
    k, n = _int8_widths(name)[layer]
    bf16 = torch.bfloat16
    for m in (1, 5, 32 * 197, 256 * 197):
        assert I.linear_variant(m, n, k, bf16) == want, (name, layer, m, k, n)
        assert I.linear_variant(m, n, k, bf16, xq_ptr=1 << 20, w_ptr=3 << 20) == want
        assert I.linear_variant(m, n, k, bf16, xq_ptr=(1 << 20) + 8) == "mma"  # a base off 16 bytes
        assert I.linear_variant(m, n, k, bf16, w_ptr=(1 << 20) + 1) == "mma"
        assert I.linear_variant(m, n, k, torch.float32) == "mma"


@pytest.mark.parametrize("k,want", [(45, "mma"), (44, "mma"), (40, "mma"), (48, "wgmma"), (1040, "wgmma"),
                                    (3416, "mma"), (4304, "wgmma"), (4308, "mma")])
def test_linear_variant_by_depth(k, want):
    assert I.linear_variant(37, 72, k, torch.bfloat16) == want
    assert I.wgmma_admits(72, k, torch.bfloat16) == (want == "wgmma")


@pytest.mark.parametrize("n,out_dtype,want", [
    (72, torch.bfloat16, "wgmma"), (8, torch.bfloat16, "wgmma"), (4304, torch.bfloat16, "wgmma"),
    (72, torch.float32, "mma"), (4304, torch.float32, "mma"), (130, torch.bfloat16, "mma"),
    (17, torch.bfloat16, "mma"), (4, torch.bfloat16, "mma"),
])
def test_linear_variant_by_output(n, out_dtype, want):
    """The wgmma body stores its tile by TMA in bfloat16 rows of 2 N bytes:
    float32 output and N no multiple of 8 go to the mma body."""
    assert I.linear_variant(37, n, 1024, out_dtype) == want
    assert I.wgmma_admits(n, 1024, out_dtype) == (want == "wgmma")


@pytest.mark.parametrize("m,n,sms,want", [
    (5, 4304, 132, 128), (5, 1152, 132, 128), (1, 72, 132, 128), (197 * 32, 1024, 132, 256),
    (197 * 32, 4096, 132, 256), (197 * 256, 3072, 132, 256), (8192, 1152, 132, 256), (640, 1024, 132, 128),
    (128 * 33, 1024, 132, 256), (5, 4304, 8, 256), (5, 1152, 8, 128),
])
def test_wgmma_block_n_rule(m, n, sms, want):
    """256-column tiles unless they are fewer than the SMs (132 on an H100
    SXM), where 128-column ones double the CTAs at work."""
    assert I.wgmma_block_n(m, n, sms=sms) == want


@pytest.mark.parametrize("k,offset,match", [
    (3416, 0, "variant 'wgmma' takes K a multiple of 16"), (45, 0, "variant 'wgmma' takes K"),
    (1024, 1, "operands on 16 bytes"),
])
def test_forced_wgmma_refused_before_any_launch(k, offset, match):
    """``_launch_linear`` refuses a body that cannot take the shape before it
    touches a card or the library (pure Python, so it runs here)."""
    I.reset_launch_counts()
    buf = torch.zeros(5 * k + offset, dtype=torch.int8)
    xq = buf[offset:].view(5, k)
    w = torch.zeros(8, k, dtype=torch.int8)
    with pytest.raises(ValueError, match=match):
        I._launch_linear("wgmma", xq, torch.ones(5), w, torch.ones(8), None, torch.bfloat16)
    with pytest.raises(ValueError, match="no body"):
        I._launch_linear("imma", xq, torch.ones(5), w, torch.ones(8), None, torch.float32)
    assert I.int8_linear.launches == 0 and not I.int8_linear.variant_launches


@pytest.mark.parametrize("n,out_dtype", [(8, torch.float32), (130, torch.bfloat16), (130, torch.float32)])
def test_forced_wgmma_refused_for_its_output(n, out_dtype):
    """A forced wgmma body that would write float32 or rows of N no multiple
    of 8 is refused before any launch."""
    I.reset_launch_counts()
    xq, w = torch.zeros(5, 1024, dtype=torch.int8), torch.zeros(n, 1024, dtype=torch.int8)
    with pytest.raises(ValueError, match=f"writes bfloat16 with N a multiple of 8: .* N {n}, {out_dtype}"):
        I._launch_linear("wgmma", xq, torch.ones(5), w, torch.ones(n), None, out_dtype)
    assert I.int8_linear.launches == 0 and not I.int8_linear.variant_launches


# --- the int8 attention branch -------------------------------------------------------------
def _intercept(names):
    """Record (input, output) of the Flax submodules called ``names``."""
    seen = {}

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and context.module.name in names:
            seen.setdefault(context.module.name, []).append((np.asarray(args[0]), np.asarray(out)))
        return out

    return seen, interceptor


def test_int8_attention_branch_matches_jax():
    kw = dict(quant_int8_attn=True)
    params = _params({})
    qtree = jvit.quantize_vit_params(params)
    x = _images()
    seen, interceptor = _intercept({"qkv", "proj"})
    with fnn.intercept_methods(interceptor):
        jvit.ViT(jvit.ViTSpec(**TINY, quant_int8=True, **kw)).apply({"params": qtree}, jnp.asarray(x))
    (_, qkv), (want_out, _) = seen["qkv"][0], seen["proj"][0]
    B, T, _ = qkv.shape
    q, k, v = (np.ascontiguousarray(a) for a in np.moveaxis(qkv.reshape(B, T, 3, 4, 16), 2, 0))

    # the int32 products, each from the JAX quantizer's int8 operands
    qq, sq = jvit._q8_dyn(jnp.asarray(q), axis=-1)
    kq, sk = jvit._q8_dyn(jnp.asarray(k), axis=-1)
    want_acc = jax.lax.dot_general(qq, kq, (((3,), (3,)), ((0, 2), (0, 2))), preferred_element_type=jnp.int32)
    pq, psq = I.quantize_plain(torch.from_numpy(q), -1)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(qq))
    np.testing.assert_array_equal(psq.numpy(), np.asarray(sq))
    acc = I.int_product("bqhd,bkhd->bhqk", pq, torch.from_numpy(np.asarray(kq)))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    scales = np.asarray(sq).transpose(0, 2, 1, 3) * np.asarray(sk).transpose(0, 2, 3, 1)
    attn = np.asarray(want_acc, np.float32) * scales
    attn = np.asarray(jax.nn.softmax(jnp.asarray(attn) * 16**-0.5, axis=-1))
    aq, _ = jvit._q8_dyn(jnp.asarray(attn), axis=-1)
    vq, _ = jvit._q8_dyn(jnp.asarray(v), axis=1)
    want_acc2 = jax.lax.dot_general(aq, vq, (((3,), (1,)), ((0, 1), (0, 2))), preferred_element_type=jnp.int32)
    paq, _ = I.quantize_plain(torch.from_numpy(attn), -1)
    pvq, _ = I.quantize_plain(torch.from_numpy(v), 1)
    np.testing.assert_array_equal(paq.numpy(), np.asarray(aq))
    np.testing.assert_array_equal(pvq.numpy(), np.asarray(vq))
    acc2 = I.int_product("bhqk,bkhd->bhqd", paq, pvq)
    np.testing.assert_array_equal(acc2.numpy(), np.asarray(want_acc2))

    # the branch's output, the input of proj
    got = pvit._int8_attention(*(torch.from_numpy(a) for a in (q, k, v))).reshape(B, T, 64)
    assert np.abs(got.numpy() - want_out).max() <= 1e-6
    # and the port's module runs it where the spec asks
    model = _int8_model({}, qtree, **kw)
    assert model.blocks[0].attn.spec.quant_int8_attn


# --- the whole int8 ViT ------------------------------------------------------------------
def _quantizer_inputs_flipped(jax_inputs, port_inputs) -> tuple[int, int]:
    flipped = total = 0
    for a, b in zip(jax_inputs, port_inputs):
        qa, _ = jvit._q8_dyn(jnp.asarray(a, jnp.float32), axis=-1)
        qb, _ = I.quantize_plain(b.float(), -1)
        flipped += int((np.asarray(qa).reshape(qb.shape) != qb.numpy()).sum())
        total += qb.numel()
    return flipped, total


@pytest.mark.parametrize("case", sorted(SPECS))
def test_int8_vit_matches_jax_in_float32(case, monkeypatch):
    kw = SPECS[case]
    qtree = jvit.quantize_vit_params(_params(kw, seed=3))
    x = _images(seed=3)
    seen, interceptor = _intercept(set(jvit.QUANT_LAYER_NAMES))
    with fnn.intercept_methods(interceptor):
        want = np.asarray(jvit.ViT(jvit.ViTSpec(**TINY, **kw, quant_int8=True)).apply({"params": qtree},
                                                                                   jnp.asarray(x)))
    model = _int8_model(kw, qtree)
    # every quantizer of the port (fused or not) ends in quantize_rows_plain on the CPU
    port_inputs, plain = [], I.quantize_rows_plain
    monkeypatch.setattr(I, "quantize_rows_plain", lambda rows: port_inputs.append(rows) or plain(rows))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    # both quantize in the same order: block by block, qkv, proj, then the MLP's; a gated MLP's fc_gate
    # and fc_up read one tensor, which the port quantizes once
    if kw.get("gated_mlp"):
        for i in range(2):
            np.testing.assert_array_equal(seen["fc_gate"][i][0], seen["fc_up"][i][0])
    mlp = ("fc_gate", "fc2") if kw.get("gated_mlp") else ("fc1", "fc2")
    jax_inputs = [seen[name][i][0] for i in range(2) for name in ("qkv", "proj", *mlp)]
    assert len(jax_inputs) == len(port_inputs) == 2 * 4
    flipped, total = _quantizer_inputs_flipped(jax_inputs, port_inputs)
    err = np.abs(got - want).max()
    print(f"{case}: max-abs {err:.3g} of {np.abs(want).max():.3g}; {flipped} of {total} xq elements flipped")
    assert got.shape == want.shape
    assert err <= 1e-3 * np.abs(want).max()


def _jax_int8_extractor(kw, qtree):
    model = jvit.ViT(jvit.ViTSpec(**TINY, **kw, quant_int8=True))
    return JaxFeatureExtractor(name="tiny", embedding_dim=64, spec=JaxPreprocessSpec(**PRE),
                               apply_fn=lambda p, x: model.apply({"params": p}, x), params=qtree,
                               device=jax.devices("cpu")[0], compute_dtype="int8")


@pytest.mark.parametrize("case", sorted(SPECS))
def test_both_engines_int8_paths_agree(case):
    kw = SPECS[case]
    qtree = jvit.quantize_vit_params(_params(kw, seed=4))
    patches = [np.random.default_rng(i).integers(0, 256, (40, 40, 3), dtype=np.uint8) for i in range(6)]
    want = _jax_int8_extractor(kw, qtree).extract_batch(patches, batch_size=4)
    ext = TorchFeatureExtractor(name="tiny", embedding_dim=64, spec=PreprocessSpec(**PRE),
                                model=_int8_model(kw, qtree), device="cpu", compute_dtype="int8")
    got = ext.extract_batch(patches, batch_size=4)
    assert got.dtype == np.float32 and got.shape == want.shape
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() >= BF16_INT8_COS, cos


def test_engine_cast_keeps_qscale_float32():
    qtree = jvit.quantize_vit_params(_params({}))
    ext = TorchFeatureExtractor(name="tiny", embedding_dim=64, spec=PreprocessSpec(**PRE),
                                model=_int8_model({}, qtree), device="cpu", compute_dtype="int8")
    dtypes = {name: t.dtype for name, t in ext.model.state_dict().items()}
    assert {d for n, d in dtypes.items() if n.endswith("weight_q")} == {torch.int8}
    assert {d for n, d in dtypes.items() if n.endswith("qscale")} == {torch.float32}
    others = {d for n, d in dtypes.items() if not n.endswith(("weight_q", "qscale"))}
    assert others == {torch.bfloat16}
    # the scales are those of the tree, unrounded
    np.testing.assert_array_equal(ext.model.blocks[0].attn.qkv.qscale.numpy(),
                                  qtree["blocks_0"]["attn"]["qkv"]["qscale"])


# --- the GELU switch ------------------------------------------------------------------------
def test_gelu_tanh_is_the_int8_default(monkeypatch):
    """Mirrors tests/test_vit_parity.py's check of the switch."""
    v = torch.tensor(-2.0)
    monkeypatch.delenv("ATLASPATCH_GELU_TANH", raising=False)
    exact, approx = float(pvit._act("gelu")(v)), float(pvit._act("gelu_tanh")(v))
    assert exact != approx
    assert float(pvit._act("gelu", quantized=True)(v)) == approx
    assert exact == pytest.approx(float(jvit._act("gelu")(jnp.float32(-2.0))), abs=1e-7)
    assert approx == pytest.approx(float(jvit._act("gelu", quantized=True)(jnp.float32(-2.0))), abs=1e-7)
    monkeypatch.setenv("ATLASPATCH_GELU_TANH", "0")
    assert float(pvit._act("gelu", quantized=True)(v)) == exact
    monkeypatch.setenv("ATLASPATCH_GELU_TANH", "1")
    assert float(pvit._act("gelu")(v)) == approx
    assert float(pvit._act("silu", quantized=True)(v)) == float(torch.nn.functional.silu(v))


@pytest.mark.parametrize("env", [None, "0"])
def test_int8_vit_follows_the_switch_like_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("ATLASPATCH_GELU_TANH", raising=False)
    else:
        monkeypatch.setenv("ATLASPATCH_GELU_TANH", env)
    qtree = jvit.quantize_vit_params(_params({}, seed=6))
    x = _images(seed=6)
    want = np.asarray(jvit.ViT(jvit.ViTSpec(**TINY, quant_int8=True)).apply({"params": qtree}, jnp.asarray(x)))
    model = _int8_model({}, qtree)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    # the pooling head of a MAP spec stays float and exact-erf
    head = pvit.ViT(pvit.ViTSpec(**TINY, pool="map", quant_int8=True)).head.mlp
    assert float(head.act(torch.tensor(-2.0))) == float(torch.nn.functional.gelu(torch.tensor(-2.0)))


# --- the zoo and the registry ---------------------------------------------------------------
def _cos_rows(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_int8_falls_back_for_non_vit(monkeypatch, caplog):
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    ext = zoo.build_extractor(zoo.ENTRIES["resnet18"], device="cpu", compute_dtype="int8", max_batch=2)
    assert ext.compute_dtype == "bfloat16"
    assert "falling back to bfloat16" in caplog.text
    kinds = {t.dtype for t in ext.model.state_dict().values()}
    assert torch.int8 not in kinds and torch.bfloat16 in kinds
    ext.cleanup()


def test_vit_b_16_int8_tracks_float32(monkeypatch):
    """The drift contract of tests/test_int8_mode.py::test_int8_features_track_float32."""
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    entry = zoo.ENTRIES["vit_b_16"]
    rng = np.random.default_rng(0)
    patches = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(4)]
    f32 = zoo.build_extractor(entry, device="cpu", compute_dtype="float32", max_batch=4)
    i8 = zoo.build_extractor(entry, device="cpu", compute_dtype="int8", max_batch=4)
    assert i8.compute_dtype == "int8"
    assert {t.dtype for t in i8.model.state_dict().values()} >= {torch.int8, torch.float32, torch.bfloat16}
    # the int8 weights are the float model's, quantized
    w = f32.model.blocks[3].mlp.fc1.weight.detach()
    want_q, want_s = I.quantize_plain(w, dim=1)
    assert torch.equal(i8.model.blocks[3].mlp.fc1.weight_q, want_q)
    assert torch.equal(i8.model.blocks[3].mlp.fc1.qscale, want_s[:, 0])
    feats_f32, feats_i8 = f32.extract_batch(patches, batch_size=4), i8.extract_batch(patches, batch_size=4)
    assert feats_i8.dtype == np.float32
    cos = _cos_rows(feats_f32, feats_i8)
    assert (cos > 0.98).all(), cos
    f32.cleanup()
    i8.cleanup()


def test_registry_accepts_int8_dtype(monkeypatch):
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    from atlaspatch_tpu_torch.services.feature_embedding import resolve_feature_dtype

    assert resolve_feature_dtype("cuda", "int8") == "int8"
    assert resolve_feature_dtype("cpu", "int8") == "float32"
    registry = zoo.build_default_registry(device="cpu", dtype="int8")
    assert "vit_b_16" in registry.available()
