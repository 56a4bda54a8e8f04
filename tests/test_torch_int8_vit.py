"""The int8 (W8A8) serving mode through both engines, on the CPU: the two
engines' bfloat16 int8 paths (per-row cosine >= BF16_INT8_COS), the
engine's cast (``qscale`` float32, ``weight_q`` int8), the GELU switch, the
registry, the fallback of other families and the drift contract (int8
against float32 cosine > 0.98). The rest of the int8 mode is in
``tests/test_torch_int8.py`` and ``tests/test_torch_int8_fused.py``.
"""

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
from torch_int8_helpers import BF16_INT8_COS, PRE, SPECS, TINY, _images, _int8_model, _params


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
