"""The port's encoder zoo (atlaspatch_tpu_torch/models/encoders/zoo.py)
against the JAX package's.

All 66 names with the JAX table's families, dims, sources, preprocessing
and specs, equal field by field (tolerance: none); all 66 build. The 9 towers
ported last (Swin, CLIP ModifiedResNet, CoCa/CONCH, BEiT3/MUSK) load a
seeded checkpoint in their upstream layout (``tests/upstream_values.py``)
from ATLASPATCH_WEIGHTS_DIR in both zoos, at depth ≤ 3 (CLIP ResNets one
bottleneck per stage), and give the JAX package's features. Weights load
from ``.npz`` archives of the JAX param tree, torchvision ``.pth`` and
``.safetensors`` checkpoints (read without the safetensors module), and give
the JAX package's features on the same file (max-abs 1e-4, float32, CPU);
missing weights raise without the random-weights switch.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from atlaspatch_tpu.models.encoders import zoo as jax_zoo
from atlaspatch_tpu.tools.convert_weights import _flatten
from atlaspatch_tpu_torch.models.encoders import zoo
from atlaspatch_tpu_torch.models.encoders.vit import ViT
from atlaspatch_tpu_torch.parallel.mesh import embedding_mesh
from tests.upstream_layouts import torchvision_vit_sd
from upstream_values import upstream_checkpoint
from torch_port_helpers import free_tmp_path, shared_vit_params  # noqa: F401 (free_tmp_path: autouse)

# the families whose towers were ported last
PENDING_FAMILIES = {"swin", "clip_modified_resnet", "coca", "conch", "beit3"}
MAX_DEPTH = 3  # tests/test_converter_harness.py:28


def test_all_66_names_in_the_jax_order():
    assert list(zoo.ENTRIES) == list(jax_zoo.ENTRIES)
    assert len(zoo.ENTRIES) == 66


@pytest.mark.parametrize("name", list(jax_zoo.ENTRIES))
def test_entry_matches_the_jax_entry(name):
    port, ref = zoo.ENTRIES[name], jax_zoo.ENTRIES[name]
    assert (port.family, port.embedding_dim, port.source) == (ref.family, ref.embedding_dim, ref.source)
    assert dataclasses.asdict(port.preprocess) == dataclasses.asdict(ref.preprocess)
    assert port.implemented and port.notes == ref.notes
    assert type(port.spec).__name__ == type(ref.spec).__name__
    assert dataclasses.asdict(port.spec) == dataclasses.asdict(ref.spec)


def test_45_vit_names_build_and_21_wait():
    # named when only the ViT family built: all 66 names build now, none waits
    assert zoo.ZOO_STATUS == jax_zoo.ZOO_STATUS
    assert len(zoo.ZOO_STATUS["implemented"]) == 66
    assert zoo.ZOO_STATUS["pending"] == []


def _cut(spec):
    """``spec`` at depth ≤ MAX_DEPTH; a CLIP ResNet at one bottleneck per stage."""
    if hasattr(spec, "trunk"):  # CoCaSpec
        return dataclasses.replace(spec, trunk=_cut(spec.trunk))
    if hasattr(spec, "layers"):  # ClipResNetSpec
        return dataclasses.replace(spec, layers=tuple(1 for _ in spec.layers))
    if isinstance(getattr(spec, "depth", None), int) and spec.depth > MAX_DEPTH:
        return dataclasses.replace(spec, depth=MAX_DEPTH)
    return spec


@pytest.mark.parametrize("name", sorted(n for n, e in jax_zoo.ENTRIES.items()
                                        if e.family in PENDING_FAMILIES))
def test_pending_towers_raise_at_create(name, tmp_path, monkeypatch):
    """Named when these 9 towers raised at create(): each builds from a
    checkpoint in its upstream layout and gives the JAX entry's features."""
    entry = dataclasses.replace(zoo.ENTRIES[name], spec=_cut(zoo.ENTRIES[name].spec))
    ref = dataclasses.replace(jax_zoo.ENTRIES[name], spec=_cut(jax_zoo.ENTRIES[name].spec))
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in zoo._TOWERS[entry.family][0](entry.spec).state_dict().items()}
    sd = upstream_checkpoint(entry, shapes, seed=len(name))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / f"{name}.pth")
    monkeypatch.setenv("ATLASPATCH_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.delenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", raising=False)
    patches = _patches(2)
    got = zoo.build_extractor(entry, device="cpu", max_batch=2).extract_batch(patches)
    want = jax_zoo.build_extractor(ref, device=jax.devices("cpu")[0], max_batch=2).extract_batch(patches)
    assert got.shape == want.shape == (2, entry.embedding_dim)
    assert np.abs(got - want).max() <= 1e-4


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
    # named when uni_v1's timm converter was not ported: it converts now
    entry = dataclasses.replace(zoo.ENTRIES["uni_v1"], spec=_cut(zoo.ENTRIES["uni_v1"].spec))
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in ViT(entry.spec).state_dict().items()}
    sd = upstream_checkpoint(entry, shapes, seed=3)
    state = zoo._convert(entry, sd)
    assert sorted(state) == sorted(shapes) and "blocks.2.ls1" in state
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    tiny, _ = _tiny_entry(monkeypatch)
    # int8 builds now (tests/test_torch_int8.py): the W8A8 ViT
    int8 = zoo.build_extractor(tiny, device="cpu", compute_dtype="int8")
    assert int8.compute_dtype == "int8" and int8.model.spec.quant_int8
    # named when meshes were refused: data-parallel int8 builds one replica per data device
    # (tests/test_torch_parallel_tp.py); named when tensor-parallel int8 was refused too: it builds a
    # replica of int8 shards over the mesh's model devices, or, with no mesh, one int8 model
    dp = zoo.build_extractor(tiny, device="cpu", compute_dtype="int8", mesh=embedding_mesh(1, ["cpu", "cpu"]))
    assert len(dp.replicas) == 2 and all(r.spec.quant_int8 for r in dp.replicas)
    one = zoo.build_extractor(tiny, device="cpu", compute_dtype="int8", tensor_parallel=True)
    assert one.replicas == [one.model] and one.model.spec.quant_int8
    tp = zoo.build_extractor(tiny, device="cpu", compute_dtype="int8", mesh=embedding_mesh(2, ["cpu", "cpu"]),
                             tensor_parallel=True)
    assert len(tp.replicas) == 1 and tp.compute_dtype == "int8"
    attn = tp.model.blocks[0].attn
    assert attn.quantized and len(attn.shards) == 2 and all(s.spec.quant_int8 for s in attn.shards)
    np.testing.assert_array_equal(tp.extract_batch(_patches(2)), one.extract_batch(_patches(2)))


def test_safetensors_without_the_module_raises(tmp_path, monkeypatch):
    """Named when reading .safetensors needed the module: the port reads them
    with its import blocked, and features match the JAX zoo's on the file."""
    import builtins

    from safetensors.numpy import save_file

    entry, ref = _tiny_entry(monkeypatch)
    rng = np.random.default_rng(12)
    sd = {k: rng.normal(0.0, 0.2, v.shape).astype(np.float32)
          for k, v in torchvision_vit_sd(ref.spec, shared_vit_params(ref.spec)).items()}
    save_file(sd, str(tmp_path / "vit_b_16.safetensors"))
    monkeypatch.setenv("ATLASPATCH_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.delenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", raising=False)
    want = jax_zoo.build_extractor(ref, device=jax.devices("cpu")[0], max_batch=4).extract_batch(
        _patches(), batch_size=4)
    real = builtins.__import__

    def no_safetensors(name, *args, **kwargs):
        if name.startswith("safetensors"):
            raise ImportError("no safetensors here")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_safetensors)
    got = zoo.build_extractor(entry, device="cpu", max_batch=4).extract_batch(_patches(), batch_size=4)
    loaded = zoo._load_state_dict(tmp_path / "vit_b_16.safetensors")
    assert sorted(loaded) == sorted(sd) and all(np.array_equal(loaded[k].numpy(), sd[k]) for k in sd)
    assert np.abs(got - want).max() <= 1e-4


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
