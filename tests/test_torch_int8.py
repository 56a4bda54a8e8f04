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
    off by one ulp may flip an int8 value; the flips are counted).
  * the row split over tensor-parallel shards, the routing of
    ``int8_linear_s8``'s bodies and the 16-byte row pitch.

The fused quantizers are in ``tests/test_torch_int8_fused.py``; the two
engines, the GELU switch, the registry and the drift contract in
``tests/test_torch_int8_vit.py``.
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
from atlaspatch_tpu_torch.models.encoders import vit as pvit
from atlaspatch_tpu_torch.models.encoders import zoo
from atlaspatch_tpu_torch.models.encoders.engine import PreprocessSpec, TorchFeatureExtractor
from atlaspatch_tpu_torch.ops import int8 as I
from torch_int8_helpers import (ACTS, PRE, SPECS, TINY, _images, _int8_model, _int8_widths, _leaf_paths, _params,
                                _rows)
from torch_port_helpers import shared_vit_params


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(1024, 1024), (4096, 1024), (4096, 4096), (8192, 4096)])
def test_split_row_at_the_zoo_tp_widths_equals_int8_dense(dtype, K, N):
    """The row-parallel products at the TP (1, 2) plan's widths (vit_l_16's
    proj and fc2, K 1,024 and 4,096, N 1,024; dinov3_vit7b16's, K 4,096 and
    8,192, N 4,096): ``int8_linear_s32_plain`` on each half of K (the
    partials the card's wgmma int32 output equals bit for bit), summed and
    dequantized by ``dequant_sum_plain``, equals JAX ``Int8Dense`` on the
    whole row; tolerance 0 (max-abs 0: int32 sums are exact in any order)."""
    kernel_q, qscale, bias = _dense_case(K, N, seed=K + 3 * N)
    x = np.random.default_rng(K + N).normal(0.0, 2.0, (2, 3, K)).astype(np.float32)
    x[0, 0, :4] = [127.0, 2.5, -3.5, 0.5]
    x[0, 0, 4:] = 0.0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    bj = jnp.asarray(bias).astype(jdt)
    _, _, want_acc, want_y = _jax_dense_parts(xj, kernel_q, qscale, bj)
    rows = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt).reshape(-1, K)
    w = torch.from_numpy(np.ascontiguousarray(kernel_q.T))
    cuts = _cuts(K, 2)
    amax = torch.maximum(*(I.row_amax_plain(rows[:, c]) for c in cuts))
    slices = [I.quantize_rows_plain(rows[:, c], amax) for c in cuts]
    partials = [I.int8_linear_s32_plain(q, w[:, c].contiguous()) for (q, _), c in zip(slices, cuts)]
    assert [p.shape for p in partials] == [(6, N)] * 2 and all(p.dtype == torch.int32 for p in partials)
    np.testing.assert_array_equal((partials[0] + partials[1]).numpy(), want_acc.reshape(-1, N))
    bias_t = torch.from_numpy(np.asarray(bj.astype(jnp.float32))).to(tdt)
    got = I.dequant_sum_plain(partials, slices[0][1], torch.from_numpy(qscale), bias_t, tdt)
    assert got.dtype == tdt
    assert np.abs(got.float().numpy() - want_y.reshape(-1, N)).max() == 0


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
    amax = torch.maximum(*(I.act_row_amax(x, act, y)[0] for x, y in halves))
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
    # the bodies: the template's entry, and the streamed one, which takes amax-only of every prologue
    # but layernorm (an activation's storing its values) and the identity's given-amax, in units of 32,
    # 16 or 8 bytes or one element
    assert I.QUANT_BODIES == ("template", "stream")
    for entry in ("atlas_quantize_rows_s8(", "atlas_quantize_rows_s8_stream("):
        assert f'extern "C" int {entry}' in src
    assert "if (bytes != 32 && bytes != 16 && bytes != 8 && bytes != (int)sizeof(T)) return false;" in src
    assert "prologue == kLayerNorm ||" in src and "(mode != kAmaxOnly && mode != kGivenAmax)" in src
    assert "(mode == kGivenAmax && (prologue != kIdentity ||" in src
    assert "(prologue == kIdentity ? (b != nullptr || act != nullptr) : act == nullptr)" in src
    assert "quantize_stream_given_kernel<T, E><<<" in src and "if constexpr (P == kIdentity) {" in src
    dispatch = re.search(r"cudaError_t dispatch_stream\(.*?\n}", src, re.S).group(0)
    cases = re.findall(r"case k(\w+): return dispatch_stream_unit<T, k\w+>", dispatch)
    assert [c.lower() for c in cases] + ["relu"] == [p.replace("_", "") for p in I.PROLOGUES if p != "layernorm"]
    outs = re.search(r"enum OutType : int \{([^}]*)\}", src).group(1)
    assert [m.strip() for m in outs.split(",")] == ["kOutF32", "kOutBF16", "kOutS32"]
    assert list(I._OUT_CODES) == [torch.float32, torch.bfloat16, torch.int32]
    assert f"kMaxPartials = {I.MAX_PARTIALS};" in src


# --- which int8_linear_s8 body a shape takes ----------------------------------------------
# the row-parallel shards of the TP (1, 2) int8 plan whose K (half of the whole) is no multiple of 16:
# medsiglip's fc2 (2,152 of 4,304) and virchow's (1,708 of the SwiGLU half-width 3,416), on mma where
# their operands are contiguous, on wgmma at the 16-byte row pitch the model gives them
_TP_S32_ON_MMA = {("medsiglip", "fc2"), ("virchow_v1", "fc2"), ("virchow_v2", "fc2")}


@pytest.mark.parametrize("name,layer,out_dtype,want", [
    *[("vit_l_16", layer, torch.bfloat16, "wgmma") for layer in ("qkv", "proj", "fc1", "fc2")],
    *[("medsiglip", layer, torch.bfloat16, "wgmma") for layer in ("qkv", "proj", "fc1", "fc2")],
    *[("uni_v1", layer, torch.bfloat16, "wgmma") for layer in ("qkv", "proj", "fc1", "fc2")],
    ("virchow_v1", "qkv", torch.bfloat16, "wgmma"), ("virchow_v1", "fc1", torch.bfloat16, "wgmma"),
    ("virchow_v1", "fc2", torch.bfloat16, "mma"), ("virchow_v2", "fc2", torch.bfloat16, "mma"),
    *[(name, layer, torch.int32, "mma" if (name, layer) in _TP_S32_ON_MMA else "wgmma")
      for name, entry in zoo.ENTRIES.items() if isinstance(getattr(entry, "spec", None), pvit.ViTSpec)
      for layer in ("proj", "fc2")],
])
def test_linear_variant_over_the_zoo_int8_widths(name, layer, out_dtype, want):
    """The wgmma body takes row pitches of a multiple of 16 bytes (a TMA
    map's row stride). Contiguous operands (pitch K): every vit_l_16,
    medsiglip and uni linear in bfloat16, the int8 engine's dtype, on wgmma;
    virchow's fc2 reads the SwiGLU half-width, K = 3,416 = 16 x 213.5, and
    goes to mma.sync, as does every float32 output. Under tensor-parallel
    int8 (the (1, 2) plan: half the heads or hidden units a shard) each zoo
    ViT's row-parallel shards write int32 partials, on wgmma (vit_l_16's
    proj K 512 and fc2 K 2,048, N 1,024; dinov3_vit7b16's 2,048 and 4,096,
    N 4,096) but where half of K is no multiple of 16: medsiglip's fc2
    (2,152) and virchow's (1,708). At the 16-byte pitch the model gives
    them (``pitch16(K)``: 3,424, 1,712, 2,160) every one of these products
    runs on wgmma."""
    k, n = _int8_widths(name)[layer]
    if out_dtype == torch.int32:
        k //= 2
    pitch = dict(ldx=I.pitch16(k), ldw=I.pitch16(k))
    for m in (1, 5, 32 * 197, 256 * 197):
        assert I.linear_variant(m, n, k, out_dtype) == want, (name, layer, m, k, n)
        assert I.linear_variant(m, n, k, out_dtype, xq_ptr=1 << 20, w_ptr=3 << 20) == want
        assert I.linear_variant(m, n, k, out_dtype, xq_ptr=(1 << 20) + 8) == "mma"  # a base off 16 bytes
        assert I.linear_variant(m, n, k, out_dtype, w_ptr=(1 << 20) + 1) == "mma"
        assert I.linear_variant(m, n, k, torch.float32) == "mma"
        assert I.linear_variant(m, n, k, out_dtype, 1 << 20, 3 << 20, **pitch) == "wgmma", (name, layer, m, k, n)
        assert I.linear_variant(m, n, k, out_dtype, xq_ptr=(1 << 20) + 8, **pitch) == "mma"
        assert I.linear_variant(m, n, k, torch.float32, **pitch) == "mma"


@pytest.mark.parametrize("k,want", [(45, "mma"), (44, "mma"), (40, "mma"), (48, "wgmma"), (1040, "wgmma"),
                                    (3416, "mma"), (4304, "wgmma"), (4308, "mma"), (512, "wgmma"), (2048, "wgmma"),
                                    (1708, "mma"), (2152, "mma")])
def test_linear_variant_by_depth(k, want):
    """bfloat16 and int32 output alike, contiguous operands (pitch K): K a
    multiple of 16 on wgmma (the TMA zero-fills the last 128-byte block's
    tail: 4,304), the rest on mma (virchow's and medsiglip's fc2 shards
    under TP (1, 2): 1,708, 2,152). The pitch decides, not K: at the 16-byte
    pitch every K goes to wgmma, at a pitch no multiple of 16 (or short of
    K) to mma, on either operand."""
    p = I.pitch16(k)
    assert p % 16 == 0 and k <= p < k + 16
    for out_dtype in (torch.bfloat16, torch.int32):
        assert I.linear_variant(37, 72, k, out_dtype) == want
        assert I.wgmma_admits(72, k, out_dtype) == (want == "wgmma")
        assert I.linear_variant(37, 72, k, out_dtype, ldx=k, ldw=k) == want
        assert I.linear_variant(37, 72, k, out_dtype, ldx=p, ldw=p) == "wgmma"
        assert I.wgmma_admits(72, k, out_dtype, ldx=p + 16, ldw=p)
        for ldx, ldw in ((p + 8, p), (p, p + 4), (p - 16, p), (p, p - 16)):
            assert I.linear_variant(37, 72, k, out_dtype, ldx=ldx, ldw=ldw) == "mma", (ldx, ldw)


@pytest.mark.parametrize("n,out_dtype,want", [
    (72, torch.bfloat16, "wgmma"), (8, torch.bfloat16, "wgmma"), (4304, torch.bfloat16, "wgmma"),
    (72, torch.float32, "mma"), (4304, torch.float32, "mma"), (130, torch.bfloat16, "mma"),
    (17, torch.bfloat16, "mma"), (4, torch.bfloat16, "mma"),
    (72, torch.int32, "wgmma"), (4, torch.int32, "wgmma"), (1000, torch.int32, "wgmma"), (1004, torch.int32, "wgmma"),
    (4096, torch.int32, "wgmma"), (130, torch.int32, "mma"), (6, torch.int32, "mma"), (17, torch.int32, "mma"),
    (72, torch.float16, "mma"),
])
def test_linear_variant_by_output(n, out_dtype, want):
    """The wgmma body stores its tile by TMA in rows whose stride must be a
    multiple of 16 bytes: bfloat16 with N a multiple of 8, int32 with N a
    multiple of 4; float32 output and other N go to the mma body."""
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
    assert I.wgmma_block_n(m, n, sms=sms, out_dtype=torch.bfloat16, K=4096) == want


@pytest.mark.parametrize("m,k,n,want", [
    (32 * 197, 512, 1024, 128), (32 * 197, 2048, 1024, 128), (32 * 201, 2048, 4096, 128), (32 * 201, 4096, 4096, 256),
    (256 * 197, 512, 1024, 128), (256 * 197, 2048, 1024, 256), (256 * 201, 2048, 4096, 256),
    (256 * 201, 4096, 4096, 256), (6144, 2048, 1024, 128), (37, 4304, 72, 128), (5, 2048, 4096, 128),
])
def test_wgmma_int32_block_n_rule(m, k, n, want):
    """The int32 tile is 128 wide unless its 256-wide tiles give each of
    the 132 SMs at least 128 K blocks of 128 bytes: at the TP (1, 2) shards
    of vit_l_16 (M 6,304) and dinov3_vit7b16 (6,432) at batch 32 only the
    7B's fc2 (K 4,096) takes 256; at batch 256 all but vit_l_16's proj do,
    as measured (PERF.md)."""
    assert I.wgmma_block_n(m, n, 132, torch.int32, k) == want


@pytest.mark.parametrize("k,offset,match", [
    (3416, 0, "variant 'wgmma' takes row pitches of a multiple of 16 bytes.* row pitches 3416 and 3416"),
    (45, 0, "variant 'wgmma' takes row pitches"), (1024, 1, "operands on 16 bytes"),
])
def test_forced_wgmma_refused_before_any_launch(k, offset, match):
    """``_launch_linear`` refuses a body that cannot take the shape before it
    touches a card or the library (pure Python, so it runs here): contiguous
    rows of a K no multiple of 16 (their pitch is K), a base off 16 bytes."""
    I.reset_launch_counts()
    buf = torch.zeros(5 * k + offset, dtype=torch.int8)
    xq = buf[offset:].view(5, k)
    w = torch.zeros(8, k, dtype=torch.int8)
    with pytest.raises(ValueError, match=match):
        I._launch_linear("wgmma", xq, torch.ones(5), w, torch.ones(8), None, torch.bfloat16)
    with pytest.raises(ValueError, match="no body"):
        I._launch_linear("imma", xq, torch.ones(5), w, torch.ones(8), None, torch.float32)
    assert I.int8_linear.launches == 0 and not I.int8_linear.variant_launches


@pytest.mark.parametrize("n,out_dtype", [(8, torch.float32), (130, torch.bfloat16), (130, torch.float32),
                                         (130, torch.int32), (6, torch.int32)])
def test_forced_wgmma_refused_for_its_output(n, out_dtype):
    """A forced wgmma body that would write float32, bfloat16 rows of N no
    multiple of 8 or int32 rows of N no multiple of 4 is refused before any
    launch."""
    I.reset_launch_counts()
    xq, w = torch.zeros(5, 1024, dtype=torch.int8), torch.zeros(n, 1024, dtype=torch.int8)
    with pytest.raises(ValueError, match=f"writes bfloat16 with N a multiple of 8 or int32 with N a multiple of 4: "
                                         f".* N {n}, {out_dtype}"):
        I._launch_linear("wgmma", xq, torch.ones(5), w, torch.ones(n), None, out_dtype)
    assert I.int8_linear.launches == 0 and not I.int8_linear.variant_launches


@pytest.mark.parametrize("out_dtype,block_n", [(torch.int32, 192), (torch.int32, 64), (torch.bfloat16, 64)])
def test_forced_wgmma_refuses_a_tile_width_it_has_no_instantiation_of(out_dtype, block_n):
    """Both outputs have two tile widths (128, 256): any other is refused
    before any launch."""
    I.reset_launch_counts()
    xq, w = torch.zeros(5, 1024, dtype=torch.int8), torch.zeros(72, 1024, dtype=torch.int8)
    s_x, qscale = (None, None) if out_dtype == torch.int32 else (torch.ones(5), torch.ones(72))
    with pytest.raises(ValueError, match=f"tiles are .* wide, got {block_n}"):
        I._launch_linear("wgmma", xq, s_x, w, qscale, None, out_dtype, block_n)
    assert I.int8_linear.launches == 0 and not I.int8_linear.out_launches


def _staged_int32_addresses(block_n: int = 128) -> np.ndarray:
    """csrc/int8_linear_wgmma.cu's stage_s32, emulated: per (warp, j, h, lane) the shared-memory
    byte offset in one consumer's slice where the lane stores its 8 bytes, and the (row, column) of
    the slice those bytes hold (the wgmma accumulator layout: thread 32 w + 4 g + t holds rows
    16 w + g and + 8, columns 8 j + 2 t and + 1)."""
    out = []
    for w in range(4):
        for j in range(block_n // 8):
            for h in range(2):
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    flip = bool(t & 2)
                    jj = j ^ 2 if flip else j
                    r = w * 16 + g
                    chunk = ((4 if flip else 0) ^ (t >> 1) ^ g) << 4
                    addr = r * 128 + 8 * (t & 1) + (j >> 2) * 8192 + h * 8 * 128 + ((32 * (j & 3)) ^ chunk)
                    out.append((w, j, h, lane, addr, r + 8 * h, 8 * jj + 2 * t))
    return np.array(out)


# --- the 16-byte row pitch ---------------------------------------------------------------
# virchow's block at the tiny width: SwiGLU of SiLU over a half-width of 44 (fc2's K: no multiple of 16,
# as virchow's 3,416 is not), LayerScale, register tokens, CLS + mean pooling
VIRCHOW_LIKE = dict(swiglu=True, act="silu", mlp_hidden=44, layerscale=True, reg_tokens=4, pool="cls_mean_concat")


def _int8_tensor(shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(-127, 128, shape, dtype=np.int8)).clone()


def _pad(t: torch.Tensor) -> torch.Tensor:
    """The pad bytes of a pitched (rows, K) view: columns K to its pitch of the buffer under it."""
    rows, k = t.shape
    return t.as_strided((rows, I.pitch16(k)), (I.pitch16(k), 1))[:, k:]


@pytest.mark.parametrize("rows,k", [(5, 3416), (3, 1708), (4, 2152), (2, 45), (3, 48), (1, 45)])
def test_pitched_gives_rows_a_16_byte_pitch(rows, k):
    """``pitched``: the same values, rows ``pitch16(K)`` bytes apart from a
    16-byte-aligned base; a tensor already so is returned as it is (K a
    multiple of 16: no copy), a misaligned or packed one copied."""
    t = _int8_tensor((rows, k), seed=k)
    p = I.pitched(t)
    assert torch.equal(p, t) and p.shape == (rows, k) and p.stride(1) == 1 and p.data_ptr() % 16 == 0
    assert rows == 1 or p.stride(0) == I.pitch16(k)
    assert (p is t) == (k % 16 == 0 or rows == 1)
    assert I.pitched(p) is p
    misaligned = torch.empty(rows * k + 1, dtype=torch.int8)[1:].view(rows, k).copy_(t)
    again = I.pitched(misaligned)
    assert again is not misaligned and torch.equal(again, t) and again.data_ptr() % 16 == 0


def test_row_pitch_of_the_operands_the_wrappers_read_in_place():
    """``int8_linear`` and ``int8_linear_s32`` read a row-pitched view where
    it lies, its pitch its row stride; a view of another layout (columns
    not unit-strided, rows overlapping) is copied to packed rows; a single
    row's stride addresses nothing, so its pitch is K's 16-byte one."""
    view = torch.zeros(6, 3424, dtype=torch.int8)[:, :3416]
    assert I._rows_of(view) is view and I._pitch(view) == 3424
    packed = I._rows_of(torch.zeros(3416, 6, dtype=torch.int8).t())
    assert packed.is_contiguous() and I._pitch(packed) == 3416
    assert I._pitch(torch.zeros(1, 3416, dtype=torch.int8)) == 3424
    assert I._pitch(torch.zeros(6, 3416, dtype=torch.int8)) == 3416
    overlapping = torch.zeros(32, dtype=torch.int8).as_strided((4, 8), (4, 1))
    assert I._rows_of(overlapping).is_contiguous()


@pytest.mark.parametrize("m,n,k", [(37, 24, 3416), (9, 16, 1708), (5, 8, 2152), (3, 8, 45), (4, 8, 64)])
def test_pitched_and_contiguous_operands_give_the_same_plain_result(m, n, k):
    """The plain versions over row-pitched xq and weights (pad bytes filled
    with 127) equal them over the packed ones, bit for bit: int32, and
    dequantized to float32 and bfloat16."""
    xq, w = _int8_tensor((m, k), seed=m), _int8_tensor((n, k), seed=n + k)
    rng = np.random.default_rng(k)
    s_x = torch.from_numpy(rng.uniform(0.01, 0.1, m).astype(np.float32))
    qscale = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)) / 127
    bias = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    px, pw = I.pitched(xq), I.pitched(w)
    if k % 16:
        assert px.stride(0) == pw.stride(0) == I.pitch16(k)
        _pad(px).fill_(127)
        _pad(pw).fill_(127)
    want = I.int8_linear_s32(xq, w)
    for a, b in ((px, pw), (px, w), (xq, pw)):
        assert torch.equal(I.int8_linear_s32(a, b), want)
        for out_dtype in (torch.float32, torch.bfloat16):
            assert torch.equal(I.int8_linear(a, s_x, b, qscale, bias, out_dtype),
                               I.int8_linear(xq, s_x, w, qscale, bias, out_dtype))


def test_pitching_leaves_the_int8_state_dict_unchanged():
    """``pitch_int8_weights``: every Int8Linear's weight_q at the 16-byte
    pitch (fc2's K 44 in a copy, the others as they were), and
    ``state_dict()``'s keys, dtypes, shapes and values as before; a state
    dict loads into the pitched model in place, keeping the pitch; the
    engine pitches the weights where the model lands."""
    qtree = jvit.quantize_vit_params(_params(VIRCHOW_LIKE, seed=6))
    model = _int8_model(VIRCHOW_LIKE, qtree)
    before = {key: t.clone() for key, t in model.state_dict().items()}
    unpitched = model.blocks[0].attn.qkv.weight_q
    assert pvit.pitch_int8_weights(model) is model
    assert model.blocks[0].attn.qkv.weight_q is unpitched  # K 64: already at its pitch
    after = model.state_dict()
    assert list(after) == list(before)
    for key, t in after.items():
        assert t.dtype == before[key].dtype and t.shape == before[key].shape and torch.equal(t, before[key]), key
    layers = [mod for mod in model.modules() if isinstance(mod, pvit.Int8Linear)]
    assert len(layers) == 2 * 4 and {mod.in_features for mod in layers} == {64, 44}
    for mod in layers:
        assert mod.weight_q.stride() == (I.pitch16(mod.in_features), 1) and mod.weight_q.data_ptr() % 16 == 0
    model.load_state_dict({key: t * (-1 if key.endswith("weight_q") else 1) for key, t in before.items()})
    fc2 = model.blocks[1].mlp.fc2.weight_q
    assert fc2.stride(0) == 48 and torch.equal(fc2, -before["blocks.1.mlp.fc2.weight_q"])
    ext = TorchFeatureExtractor(name="tiny", embedding_dim=128, spec=PreprocessSpec(**PRE),
                                model=_int8_model(VIRCHOW_LIKE, qtree), device="cpu", compute_dtype="int8")
    assert ext.model.blocks[0].mlp.fc2.weight_q.stride(0) == 48
    assert torch.equal(ext.model.blocks[0].mlp.fc2.weight_q, before["blocks.0.mlp.fc2.weight_q"])


def test_pitched_virchow_like_int8_vit_matches_jax_in_float32(monkeypatch):
    """A virchow-like int8 ViT (VIRCHOW_LIKE) through row-pitched tensors, as
    the card runs it (weights pitched, the quantizers' xq handed over at
    the 16-byte pitch): equal to the packed model bit for bit, and within
    test_int8_vit_matches_jax_in_float32's bar of JAX's Int8Dense path."""
    qtree = jvit.quantize_vit_params(_params(VIRCHOW_LIKE, seed=7))
    x = _images(seed=7)
    want = np.asarray(jvit.ViT(jvit.ViTSpec(**TINY, **VIRCHOW_LIKE, quant_int8=True)).apply(
        {"params": qtree}, jnp.asarray(x)))
    with torch.no_grad():
        packed = _int8_model(VIRCHOW_LIKE, qtree)(torch.from_numpy(x)).numpy()
    model = pvit.pitch_int8_weights(_int8_model(VIRCHOW_LIKE, qtree))
    plain, pitches = I.quantize_rows_plain, []

    def pitched_rows(rows, *amax):
        xq, s_x = plain(rows, *amax)
        xq = I.pitched(xq)
        pitches.append((xq.shape[1], xq.stride(0)))
        return xq, s_x

    monkeypatch.setattr(I, "quantize_rows_plain", pitched_rows)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert sorted(set(pitches)) == [(44, 48), (64, 64)] and len(pitches) == 2 * 4
    np.testing.assert_array_equal(got, packed)
    err = np.abs(got - want).max()
    print(f"virchow-like, pitched: max-abs {err:.3g} of {np.abs(want).max():.3g}")
    assert got.shape == want.shape == (3, 128) and err <= 1e-3 * np.abs(want).max()


def test_int32_staging_fills_the_swizzled_panels_once_without_bank_conflicts():
    """The int32 epilogue's staging, emulated: every 8 bytes of a consumer's four 32-column panels
    written once, each with the column pair that TMA's SWIZZLE_128B layout puts there (row r's
    16-byte chunk c at c ^ (r % 8), 128 bytes a row, 8 KB a panel), and each half-warp's store
    touching all 32 banks once (16 lanes x 8 bytes)."""
    a = _staged_int32_addresses()
    addr, row, col = a[:, 4], a[:, 5], a[:, 6]
    assert sorted(addr) == list(range(0, 4 * 8192, 8))
    panel, within = col // 32, col % 32
    want = panel * 8192 + row * 128 + (((4 * within // 16) ^ (row % 8)) << 4) + (4 * within) % 16
    assert np.array_equal(addr, want)
    for key in {(w, j, h) for w, j, h in a[:, :3].tolist()}:
        sel = a[(a[:, 0] == key[0]) & (a[:, 1] == key[1]) & (a[:, 2] == key[2])]
        for half in (sel[:16], sel[16:]):
            banks = sorted(b for x in half[:, 4] for b in ((x // 4) % 32, (x // 4 + 1) % 32))
            assert banks == list(range(32)), key


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
