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
  * the GELU switch, the registry, the fallback of other families, the
    drift contract (int8 against float32 cosine > 0.98) and the engine's
    cast, which keeps ``qscale`` float32 and ``weight_q`` int8.
"""

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
PRE = dict(crop=32, resize=32, mode="square")
# The two engines round bfloat16 at other places (XLA rounds each op of the
# tanh GELU and of LayerNorm's normalization to bfloat16, torch each of its
# own ops once), and the int8 quantizers turn such last-bit differences into
# flipped int8 values. Over 9 seeded (spec, weights) pairs the port's int8
# path read per-row cosine >= 0.99864 against the JAX one, the size of each
# engine's own int8-against-float32 drift at this width (>= 0.99898).
BF16_INT8_COS = 0.998


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
        flipped += int((np.asarray(qa) != qb.numpy()).sum())
        total += qb.numel()
    return flipped, total


@pytest.mark.parametrize("case", sorted(SPECS))
def test_int8_vit_matches_jax_in_float32(case):
    kw = SPECS[case]
    qtree = jvit.quantize_vit_params(_params(kw, seed=3))
    x = _images(seed=3)
    seen, interceptor = _intercept(set(jvit.QUANT_LAYER_NAMES))
    with fnn.intercept_methods(interceptor):
        want = np.asarray(jvit.ViT(jvit.ViTSpec(**TINY, **kw, quant_int8=True)).apply({"params": qtree},
                                                                                   jnp.asarray(x)))
    model = _int8_model(kw, qtree)
    port_inputs = []
    hooks = [m.register_forward_hook(lambda mod, args, out: port_inputs.append(args[0]))
             for m in model.modules() if isinstance(m, pvit.Int8Linear)]
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    for h in hooks:
        h.remove()
    # both run the layers in the same order: block by block, qkv, proj, then the MLP's
    mlp = ("fc_gate", "fc_up", "fc2") if kw.get("gated_mlp") else ("fc1", "fc2")
    jax_inputs = [seen[name][i][0] for i in range(2) for name in ("qkv", "proj", *mlp)]
    assert len(jax_inputs) == len(port_inputs) == 2 * (2 + len(mlp))
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
