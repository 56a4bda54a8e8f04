"""The port's embedding engine (atlaspatch_tpu_torch/models/encoders/engine.py)
against the JAX package's, on the CPU.

Host preprocessing must be byte-identical (tolerance: none) and ``_bucket``
equal. ``extract_batch`` of ``TorchFeatureExtractor`` is held against
``JaxFeatureExtractor`` on a tiny ViT sharing one Flax param tree, through the
engine's paths (ragged last chunk, ``max_batch``, deferred and blocking
fetches, dispatch depth 1 and 2, a deferred window of one chunk): max-abs
1e-4 in float32. bfloat16 is held to per-row cosine > 0.995 against float32
(the JAX bar, tests/test_zoo.py). The refusals (no card, an unknown dtype) raise.
"""

import jax
import numpy as np
import pytest
import torch

from atlaspatch_tpu.models.encoders.engine import JaxFeatureExtractor
from atlaspatch_tpu.models.encoders.engine import PreprocessSpec as JaxPreprocessSpec
from atlaspatch_tpu.models.encoders.engine import _bucket as jax_bucket
from atlaspatch_tpu.models.encoders.vit import ViT as JaxViT
from atlaspatch_tpu.models.encoders.vit import ViTSpec as JaxViTSpec
from atlaspatch_tpu_torch.models.encoders.engine import PreprocessSpec, TorchFeatureExtractor, _bucket
from atlaspatch_tpu_torch.models.encoders.vit import ViT, ViTSpec, flax_vit_to_torch
from atlaspatch_tpu_torch.utils import perf
from torch_port_helpers import shared_vit_params as flax_params

TOL = 1e-4
SPEC_KW = dict(img_size=32, patch_size=8, dim=32, depth=2, heads=4)
PRE = dict(crop=32, resize=36, mode="shortest", interpolation="bicubic")
INTERPS = ("bilinear", "bicubic", "nearest", "lanczos")


def _patches(n: int, seed: int = 0, size=(48, 48)) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*size, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def params():
    return flax_params(JaxViTSpec(**SPEC_KW), seed=5)


def _jax_extractor(params, **kw):
    model = JaxViT(JaxViTSpec(**SPEC_KW))
    return JaxFeatureExtractor(
        name="tiny", embedding_dim=32, spec=JaxPreprocessSpec(**PRE),
        apply_fn=lambda p, x: model.apply({"params": p}, x), params=params,
        device=jax.devices("cpu")[0], **kw,
    )


def _port_extractor(params, **kw):
    model = ViT(ViTSpec(**SPEC_KW))
    model.load_state_dict(flax_vit_to_torch(params), strict=True)
    return TorchFeatureExtractor(name="tiny", embedding_dim=32, spec=PreprocessSpec(**PRE),
                                 model=model, device="cpu", **kw)


# --- host preprocessing ----------------------------------------------------------
@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("mode", ["square", "shortest"])
def test_apply_host_is_byte_identical(mode, interp):
    kw = dict(crop=24, resize=28, mode=mode, interpolation=interp, mean=(0.5, 0.4, 0.3))
    port, ref = PreprocessSpec(**kw), JaxPreprocessSpec(**kw)
    rng = np.random.default_rng(INTERPS.index(interp) + 10 * (mode == "square"))
    shapes = [(24, 24), (28, 28), (40, 33), (33, 40), (17, 60), (64, 64)]
    for h, w in shapes:
        patch = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got, want = port.apply_host(patch), ref.apply_host(patch)
        assert got.dtype == want.dtype == np.uint8 and got.shape == (24, 24, 3)
        assert got.tobytes() == want.tobytes(), (h, w)
    gray = rng.integers(0, 256, (30, 30), dtype=np.uint8)  # converted to RGB first
    assert port.apply_host(gray).tobytes() == ref.apply_host(gray).tobytes()


def test_unknown_mode_raises_in_both():
    for cls in (PreprocessSpec, JaxPreprocessSpec):
        with pytest.raises(ValueError):
            cls(mode="diagonal").apply_host(np.zeros((8, 8, 3), np.uint8))


def test_bucket_matches():
    for max_batch in (1, 2, 7, 8, 32, 256):
        for n in range(0, 300):
            assert _bucket(n, max_batch) == jax_bucket(n, max_batch), (n, max_batch)


# --- extract_batch -----------------------------------------------------------------
@pytest.mark.parametrize(
    "n,batch_size,max_batch,deferred,depth,window",
    [
        (11, 4, 256, "1", "2", "64"),  # ragged last chunk, deferred, depth 2
        (11, 4, 256, "0", "1", "64"),  # blocking fetches, depth 1
        (11, 4, 256, "1", "1", "1"),  # deferred window of one chunk
        (13, 16, 8, "1", "2", "64"),  # max_batch caps the chunk
        (3, None, 256, "0", "2", "64"),  # one chunk of the whole list, bucket 4
    ],
)
def test_extract_batch_matches_the_jax_engine(params, monkeypatch, n, batch_size, max_batch,
                                              deferred, depth, window):
    monkeypatch.setenv("ATLASPATCH_DEFERRED_FETCH", deferred)
    monkeypatch.setenv("ATLASPATCH_H2D_DEPTH", depth)
    monkeypatch.setenv("ATLASPATCH_DEFERRED_MAX_CHUNKS", window)
    patches = _patches(n, seed=n)
    want = _jax_extractor(params, max_batch=max_batch).extract_batch(patches, batch_size=batch_size)
    got = _port_extractor(params, max_batch=max_batch).extract_batch(patches, batch_size=batch_size)
    assert got.dtype == np.float32 and got.shape == want.shape == (n, 32)
    assert np.abs(got - want).max() <= TOL


def test_empty_batch(params):
    out = _port_extractor(params).extract_batch([])
    assert out.shape == (0, 32) and out.dtype == np.float32


def test_stage_counters_are_the_references(params, monkeypatch):
    monkeypatch.setenv("ATLASPATCH_PROFILE", "1")
    perf.reset()
    _port_extractor(params).extract_batch(_patches(9), batch_size=4)
    stages = perf.report()
    perf.reset()
    assert {"embed_prep", "embed_dispatch", "embed_forward", "embed_slot_wait", "embed_drain", "embed_fetch",
            "embed_rows", "embed_pad_rows", "embed_device_span", "embed_device_gap"} == set(stages)
    assert stages["embed_dispatch"]["count"] == stages["embed_forward"]["count"] == 3
    assert stages["embed_rows"]["count"] == 9 and stages["embed_pad_rows"]["count"] == 0


def test_bf16_params_and_features(params, monkeypatch):
    patches = _patches(8, seed=2)
    f32 = _port_extractor(params).extract_batch(patches, batch_size=4)
    ext = _port_extractor(params, compute_dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in ext.model.parameters())
    bf16 = ext.extract_batch(patches, batch_size=4)
    assert bf16.dtype == np.float32
    cos = (f32 * bf16).sum(1) / (np.linalg.norm(f32, axis=1) * np.linalg.norm(bf16, axis=1))
    assert cos.min() > 0.995
    monkeypatch.setenv("ATLASPATCH_FEATURE_D2H_BF16", "1")
    fetched = _port_extractor(params).extract_batch(patches, batch_size=4)
    assert fetched.dtype == np.float32
    np.testing.assert_array_equal(fetched, torch.from_numpy(f32).bfloat16().float().numpy())


# --- refusals ----------------------------------------------------------------------
def test_cuda_without_a_card_raises(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchFeatureExtractor(
            name="x", embedding_dim=32, spec=PreprocessSpec(), model=ViT(ViTSpec(**SPEC_KW)),
            device="cuda",
        )


def test_int8_raises(params):
    """int8 is a compute dtype now (bfloat16 activations; tests/test_torch_int8.py
    holds the W8A8 ViT); a dtype the engine does not know still raises."""
    ext = _port_extractor(params, compute_dtype="int8")
    assert ext.compute_dtype == "int8" and all(p.dtype == torch.bfloat16 for p in ext.model.parameters())
    with pytest.raises(ValueError, match="unknown compute dtype"):
        _port_extractor(params, compute_dtype="int4")
