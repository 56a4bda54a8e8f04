"""The port's encoder zoo (atlaspatch_tpu_torch/models/encoders/zoo.py)
against the JAX package's.

All 66 names with the JAX table's families, dims, sources and preprocessing;
the ViT, ResNet and ConvNeXt specs equal field by field (tolerance: none).
The 9 towers not ported raise at ``create()``. Weights load from ``.npz`` archives of the JAX
param tree and from torchvision ``.pth`` checkpoints, and give the JAX
package's features on the same file (max-abs 1e-4, float32, CPU); missing
weights raise without the random-weights switch.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from atlaspatch_tpu.models.encoders import zoo as jax_zoo
from atlaspatch_tpu.tools.convert_weights import _flatten
from atlaspatch_tpu_torch.models.encoders import zoo
from tests.upstream_layouts import torchvision_vit_sd
from torch_port_helpers import shared_vit_params

PENDING_FAMILIES = {"swin", "clip_modified_resnet", "coca", "conch", "beit3"}


def test_all_66_names_in_the_jax_order():
    assert list(zoo.ENTRIES) == list(jax_zoo.ENTRIES)
    assert len(zoo.ENTRIES) == 66


@pytest.mark.parametrize("name", list(jax_zoo.ENTRIES))
def test_entry_matches_the_jax_entry(name):
    port, ref = zoo.ENTRIES[name], jax_zoo.ENTRIES[name]
    assert (port.family, port.embedding_dim, port.source) == (ref.family, ref.embedding_dim, ref.source)
    assert dataclasses.asdict(port.preprocess) == dataclasses.asdict(ref.preprocess)
    if port.family in PENDING_FAMILIES:
        assert not port.implemented and port.spec is None and "item 7" in port.notes
    else:
        assert port.implemented
        assert dataclasses.asdict(port.spec) == dataclasses.asdict(ref.spec)


def test_45_vit_names_build_and_21_wait():
    # named when only the ViT family built: the 8 ResNet and 4 ConvNeXt names build now
    assert len(zoo.ZOO_STATUS["implemented"]) == 45 + 12
    assert len(zoo.ZOO_STATUS["pending"]) == 21 - 12
    assert {zoo.ENTRIES[n].family for n in zoo.ZOO_STATUS["pending"]} == PENDING_FAMILIES


@pytest.mark.parametrize("name", sorted(n for n, e in jax_zoo.ENTRIES.items()
                                        if e.family in PENDING_FAMILIES))
def test_pending_towers_raise_at_create(name, monkeypatch):
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    registry = zoo.build_default_registry(device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        registry.create(name)


def test_registry_is_lazy_and_case_insensitive(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    registry = zoo.build_default_registry()  # "cuda" by default, touched only at create()
    assert registry.available() == sorted(jax_zoo.ENTRIES)
    assert "VIT_L_16" in registry
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.create("vit_b_32")


def _tiny_entry(monkeypatch):
    """vit_b_16's entry cut to a tiny spec of the same family."""
    entry = dataclasses.replace(
        zoo.ENTRIES["vit_b_16"],
        spec=dataclasses.replace(zoo.ENTRIES["vit_b_16"].spec, img_size=32, patch_size=8, dim=32,
                                 depth=2, heads=4),
        preprocess=dataclasses.replace(zoo.ENTRIES["vit_b_16"].preprocess, crop=32, resize=36),
    )
    ref = dataclasses.replace(
        jax_zoo.ENTRIES["vit_b_16"],
        spec=dataclasses.replace(jax_zoo.ENTRIES["vit_b_16"].spec, img_size=32, patch_size=8, dim=32,
                                 depth=2, heads=4),
        preprocess=dataclasses.replace(jax_zoo.ENTRIES["vit_b_16"].preprocess, crop=32, resize=36),
    )
    return entry, ref


def _patches(n=5):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (40, 40, 3), dtype=np.uint8) for _ in range(n)]


def _same_features(entry, ref):
    got = zoo.build_extractor(entry, device="cpu", max_batch=4).extract_batch(_patches(), batch_size=4)
    want = jax_zoo.build_extractor(ref, device=jax.devices("cpu")[0], max_batch=4).extract_batch(
        _patches(), batch_size=4)
    assert got.shape == want.shape == (5, 32)
    assert np.abs(got - want).max() <= 1e-4


def test_npz_weights_load_as_in_jax(tmp_path, monkeypatch):
    entry, ref = _tiny_entry(monkeypatch)
    params = shared_vit_params(ref.spec, seed=7)
    np.savez(tmp_path / "vit_b_16.npz", **_flatten(params))
    monkeypatch.setenv("ATLASPATCH_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.delenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", raising=False)
    assert zoo._find_cached_weights(entry) == tmp_path / "vit_b_16.npz"
    _same_features(entry, ref)


@pytest.mark.parametrize("wrap", [None, "model", "state_dict"])
def test_torchvision_pth_weights_load_as_in_jax(tmp_path, monkeypatch, wrap):
    entry, ref = _tiny_entry(monkeypatch)
    rng = np.random.default_rng(11)
    sd = {k: torch.from_numpy(rng.normal(0.0, 0.2, v.shape).astype(np.float32))
          for k, v in torchvision_vit_sd(ref.spec, shared_vit_params(ref.spec)).items()}
    sd = {f"module.{k}": v for k, v in sd.items()}  # a DataParallel prefix, stripped in both
    torch.save({wrap: sd} if wrap else sd, tmp_path / "vit_b_16.pth")
    monkeypatch.setenv("ATLASPATCH_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.delenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", raising=False)
    _same_features(entry, ref)


def test_missing_weights_raise_without_the_switch(monkeypatch, tmp_path):
    monkeypatch.setenv("ATLASPATCH_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.delenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", raising=False)
    entry, _ = _tiny_entry(monkeypatch)
    with pytest.raises(RuntimeError, match="No cached weights"):
        zoo.build_extractor(entry, device="cpu")
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    ext = zoo.build_extractor(entry, device="cpu")
    assert ext.extract_batch(_patches(2)).shape == (2, 32)


def test_unported_converter_and_requests_raise(tmp_path, monkeypatch):
    entry = dataclasses.replace(zoo.ENTRIES["uni_v1"])
    with pytest.raises(NotImplementedError, match="converter is not yet ported"):
        zoo._convert(entry, {})
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    tiny, _ = _tiny_entry(monkeypatch)
    with pytest.raises(NotImplementedError, match="item 8"):
        zoo.build_extractor(tiny, device="cpu", compute_dtype="int8")
    with pytest.raises(NotImplementedError, match="item 9"):
        zoo.build_extractor(tiny, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="item 9"):
        zoo.build_extractor(tiny, device="cpu", tensor_parallel=True)


def test_safetensors_without_the_module_raises(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_safetensors(name, *args, **kwargs):
        if name.startswith("safetensors"):
            raise ImportError("no safetensors here")
        return real(name, *args, **kwargs)

    (tmp_path / "w.safetensors").write_bytes(b"")
    monkeypatch.setattr(builtins, "__import__", no_safetensors)
    with pytest.raises(ImportError, match="safetensors module"):
        zoo._load_state_dict(tmp_path / "w.safetensors")


def test_helpers_match_the_jax_zoo(tmp_path):
    sd = {"module.model.a": 1, "module.model.b": 2, "c": 3}
    assert zoo._strip_prefixes(sd) == jax_zoo._strip_prefixes(sd)
    for i in (1, 2, 3):
        (tmp_path / f"model-0000{i}-of-00003.bin").touch()
    assert zoo._shard_group(tmp_path / "model-00002-of-00003.bin") == jax_zoo._shard_group(
        tmp_path / "model-00002-of-00003.bin")
    (tmp_path / "model-00003-of-00003.bin").unlink()
    with pytest.raises(RuntimeError, match="missing shard"):
        zoo._shard_group(tmp_path / "model-00001-of-00003.bin")
    flat = {"a/b/c": 1, "a/d": 2, "e": 3}
    from atlaspatch_tpu.tools.convert_weights import unflatten

    assert zoo.unflatten(flat) == unflatten(flat)
