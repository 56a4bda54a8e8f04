"""The port's checkpoint converters (atlaspatch_tpu_torch/models/encoders/
{convert,swin,clip_resnet,coca,beit3,resnet,convnext}.py via ``zoo._convert``)
against the JAX package's, for all 66 zoo names.

For each name, at depth ≤ the JAX harness's ``MAX_DEPTH`` (3; the two 7B
DINOv3 names at depth 1: their q/k/v concatenation alone is 201 MB per
block and side), a state dict in the exact upstream layout is built by
``tests/upstream_layouts.py::synth_state_dict`` from the JAX tower's init
shapes, and seeded values are written into it: 64 random entries per tensor
at random positions (the rest stay zero, so the arrays' untouched pages cost
no memory even at 7B width), which a swapped, mis-sliced or untransposed
tensor cannot keep in place. The port's ``_convert`` of that dict must equal
``flax_*_to_torch`` of the JAX ``_convert``'s tree key for key, max-abs 0,
and load into the port's tower (built on the meta device) with every key and
shape. Then the upstream naming quirks, each through both packages: the
``vit.`` / ``dinov2.`` / ``module.`` prefixes, HF CLIP's ``pre_layrnorm``
typo and its fixed spelling, DINOv3's ``norm`` key, timm's bare ``proj``
matrix, CHIEF's old and new downsample layouts, MUSK's keys without the
``.A`` expert, and conch_v15's missing projection (a KeyError in both).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlaspatch_tpu.models.encoders import zoo as jax_zoo
from atlaspatch_tpu_torch.models.encoders import zoo
from tests.upstream_layouts import synth_state_dict

MAX_DEPTH = 3  # tests/test_converter_harness.py:28
SEEDED_ENTRIES = 64


def _cut(spec, depth):
    if hasattr(spec, "trunk"):  # CoCaSpec
        return dataclasses.replace(spec, trunk=_cut(spec.trunk, depth))
    if hasattr(spec, "depth") and isinstance(spec.depth, int) and spec.depth > depth:
        return dataclasses.replace(spec, depth=depth)
    return spec


def _entries(name):
    """(port entry, JAX entry) at the depth this test runs them."""
    depth = 1 if name.startswith("dinov3_vit7b") else MAX_DEPTH
    port, ref = zoo.ENTRIES[name], jax_zoo.ENTRIES[name]
    return (dataclasses.replace(port, spec=_cut(port.spec, depth)),
            dataclasses.replace(ref, spec=_cut(ref.spec, depth)))


def _input_size(entry) -> int:
    spec = entry.spec
    for attr in ("img_size", "image_size"):
        for s in (spec, getattr(spec, "trunk", None)):
            if hasattr(s, attr):
                return int(getattr(s, attr))
    return int(entry.preprocess.crop)


def _upstream(ref, seed: int) -> dict:
    """The upstream-layout state dict of ``ref``'s tower, with seeded values."""
    size = _input_size(ref)
    target = jax.eval_shape(lambda: jax_zoo._model_for(ref).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32)))["params"]
    sd = synth_state_dict(ref, jax.tree.map(lambda x: x, target))
    rng = np.random.default_rng(seed)
    for key in sorted(sd):
        flat = sd[key].reshape(-1)
        n = min(SEEDED_ENTRIES, flat.size)
        flat[rng.choice(flat.size, n, replace=False)] = rng.normal(0.0, 1.0, n).astype(np.float32)
    return sd


def _assert_same_state(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert torch.equal(got[key].float(), want[key].float()), key


def _jax_route(port_entry, ref, sd) -> dict:
    """flax_*_to_torch of the JAX converter's tree (the port's carry-over)."""
    return zoo._TOWERS[port_entry.family][1](jax_zoo._convert(ref, sd))


def _meta_shapes(entry) -> dict:
    with torch.device("meta"):
        model = zoo._TOWERS[entry.family][0](entry.spec)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", sorted(jax_zoo.ENTRIES))
def test_converter_matches_the_jax_one(name):
    entry, ref = _entries(name)
    sd = _upstream(ref, seed=sorted(jax_zoo.ENTRIES).index(name))
    got = zoo._convert(entry, {k: torch.from_numpy(v) for k, v in sd.items()})
    _assert_same_state(got, _jax_route(entry, ref, sd))
    assert {k: tuple(v.shape) for k, v in got.items()} == _meta_shapes(entry)


def _both(name, sd) -> None:
    entry, ref = _entries(name)
    _assert_same_state(zoo._convert(entry, sd), _jax_route(entry, ref, sd))


@pytest.mark.parametrize("name,prefix", [("phikon_v1", ""), ("phikon_v1", "vit."),
                                         ("hibou_b", ""), ("hibou_b", "dinov2."),
                                         ("uni_v1", "module."), ("uni_v1", "module.backbone."),
                                         ("musk", "model.")])
def test_prefixes(name, prefix):
    sd = _upstream(_entries(name)[1], seed=1)
    default = {"phikon_v1": "vit.", "hibou_b": "dinov2."}.get(name, "")
    _both(name, {prefix + k[len(default):]: v for k, v in sd.items()})


@pytest.mark.parametrize("spelling", ["pre_layrnorm", "pre_layernorm"])
def test_hf_clip_pre_layernorm_spellings(spelling):
    sd = _upstream(_entries("plip")[1], seed=2)
    _both("plip", {k.replace("pre_layrnorm", spelling): v for k, v in sd.items()})


def test_dinov3_norm_key_and_absent_k_bias():
    sd = _upstream(_entries("dinov3_vits16")[1], seed=3)
    assert not any(k.endswith("k_proj.bias") for k in sd)  # upstream has none: zeros in both
    _both("dinov3_vits16", {k.replace("layernorm.", "norm.", 1) if k.startswith("layernorm.") else k: v
                            for k, v in sd.items()})


def test_timm_bare_proj_matrix():
    sd = _upstream(_entries("conch_v15")[1], seed=4)
    sd["proj"] = np.ascontiguousarray(sd.pop("proj.weight").T)
    _both("conch_v15", sd)


def test_conch_v15_without_proj_raises_in_both():
    entry, ref = _entries("conch_v15")
    sd = _upstream(ref, seed=5)
    del sd["proj.weight"]
    for convert, e in ((zoo._convert, entry), (jax_zoo._convert, ref)):
        with pytest.raises(KeyError, match="projection"):
            convert(e, sd)


def test_chief_new_downsample_layout():
    """CHIEF ships the old timm layout (layers.i.downsample → layers.{i+1});
    a checkpoint already in the new one converts the same."""
    old = _upstream(_entries("chief-ctranspath")[1], seed=6)
    new = {}
    for k, v in old.items():
        for i in (2, 1, 0):
            if k.startswith(f"layers.{i}.downsample."):
                k = k.replace(f"layers.{i}.", f"layers.{i + 1}.", 1)
                break
        new[k] = v
    assert not any(k.startswith("layers.0.downsample.") for k in new)
    _both("chief-ctranspath", new)
    entry, _ = _entries("chief-ctranspath")
    _assert_same_state(zoo._convert(entry, new), zoo._convert(entry, old))


def test_musk_keys_without_the_vision_expert():
    sd = _upstream(_entries("musk")[1], seed=7)
    _both("musk", {k.replace(".A.", "."): v for k, v in sd.items()})


def test_convert_flax_is_the_jax_convert():
    """The port's ``_convert_flax`` (what tools/convert_weights writes) gives
    the JAX tree, leaf for leaf, for one name of each family."""
    by_family = {}
    for name, e in jax_zoo.ENTRIES.items():
        by_family.setdefault(e.family, name)
    for name in by_family.values():
        entry, ref = _entries(name)
        sd = _upstream(ref, seed=8)
        got = jax.tree_util.tree_flatten_with_path(zoo._convert_flax(entry, sd))[0]
        want = jax.tree_util.tree_flatten_with_path(jax_zoo._convert(ref, sd))[0]
        assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want], name
        for (path, a), (_, b) in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b)), (name, jax.tree_util.keystr(path))
