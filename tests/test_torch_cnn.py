"""The port's ResNet and ConvNeXt encoders (atlaspatch_tpu_torch/models/encoders/
{resnet,convnext}.py) against the JAX package's Flax towers.

* Through the carry-over functions (``flax_resnet_to_torch``,
  ``flax_convnext_to_torch``): the same Flax params, from a seed, in both; tiny
  specs of each block kind plus resnet18 and convnext_tiny at full width on
  2 images. float32 on the CPU, max-abs within 1e-4.
* Through the torchvision layout: a state_dict with torchvision's keys (the
  ``fc`` / ``classifier`` head and ``num_batches_tracked`` counters included),
  made with numpy from a seed, loaded by the port as it is and by the JAX
  package's converters; max-abs within 1e-4.
* Through the zoos: the same ``.pth`` in ATLASPATCH_WEIGHTS_DIR found by both,
  ``extract_batch`` against ``JaxFeatureExtractor`` on the same patches
  (max-abs within 1e-4); every resnet and convnext name builds, with the JAX
  tower's parameter count; bfloat16 casts every parameter (per-row cosine
  > 0.995 against float32).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlaspatch_tpu.models.encoders import zoo as jax_zoo
from atlaspatch_tpu.models.encoders.convnext import ConvNeXt as JaxConvNeXt
from atlaspatch_tpu.models.encoders.convnext import ConvNeXtSpec as JaxConvNeXtSpec
from atlaspatch_tpu.models.encoders.convnext import torchvision_convnext_to_flax
from atlaspatch_tpu.models.encoders.resnet import ResNet as JaxResNet
from atlaspatch_tpu.models.encoders.resnet import ResNetSpec as JaxResNetSpec
from atlaspatch_tpu.models.encoders.resnet import torchvision_resnet_to_flax
from atlaspatch_tpu_torch.models.encoders import zoo
from atlaspatch_tpu_torch.models.encoders.convnext import (
    ConvNeXt,
    ConvNeXtSpec,
    flax_convnext_to_torch,
    torchvision_convnext_to_torch,
)
from atlaspatch_tpu_torch.models.encoders.resnet import (
    ResNet,
    ResNetSpec,
    flax_resnet_to_torch,
    torchvision_resnet_to_torch,
)
from torch_port_helpers import free_tmp_path, torchvision_cnn_sd  # noqa: F401 (free_tmp_path: autouse)

TOL = 1e-4  # float32, CPU, max-abs
COSINE_BF16 = 0.995

# per family: JAX tower, port tower, carry-over, JAX torchvision converter,
# port torchvision converter
_RESNET = (JaxResNet, ResNet, flax_resnet_to_torch, torchvision_resnet_to_flax,
           torchvision_resnet_to_torch)
_CONVNEXT = (JaxConvNeXt, ConvNeXt, flax_convnext_to_torch, torchvision_convnext_to_flax,
             torchvision_convnext_to_torch)
# case → (family, spec arguments, input size)
CASES = {
    "resnet-basic-tiny": (_RESNET, ((1, 2, 1, 1), False), 64),
    "resnet-bottleneck-tiny": (_RESNET, ((1, 2, 1, 1), True), 64),
    "resnet18": (_RESNET, ((2, 2, 2, 2), False), 224),
    "convnext-tiny-spec": (_CONVNEXT, ((1, 2, 1, 1), (8, 16, 24, 32)), 64),
    "convnext_tiny": (_CONVNEXT, ((3, 3, 9, 3), (96, 192, 384, 768)), 224),
}


def _specs(kind, args):
    if kind is _RESNET:
        return JaxResNetSpec(*args), ResNetSpec(*args)
    return JaxConvNeXtSpec(*args), ConvNeXtSpec(*args)


def _flax_shapes(tower, spec, size):
    return jax.eval_shape(lambda: tower(spec).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))["params"])


def _flax_params(tower, spec, size, seed):
    """Every leaf of the Flax tree drawn from numpy: kernels N(0, 1/fan_in)
    (Flax's LeCun law), BatchNorm / LayerNorm scales, variances and layer
    scales in [0.5, 1.5], shifts and means N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            value = rng.normal(0.0, math.sqrt(1.0 / np.prod(leaf.shape[:-1])), leaf.shape)
        elif name in ("scale", "var", "gamma"):
            value = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            value = rng.normal(0.0, 0.1, leaf.shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, _flax_shapes(tower, spec, size))


def _jax_features(tower, spec, params, images) -> np.ndarray:
    apply = jax.jit(lambda p, x: tower(spec).apply({"params": p}, x))
    return np.asarray(apply(params, jnp.asarray(images)))


def _images(n, size, seed=0):
    return np.random.default_rng(seed).normal(0.0, 1.0, (n, size, size, 3)).astype(np.float32)


def _port(tower, spec, state):
    model = tower(spec)
    model.load_state_dict(state, strict=True)
    return model.eval()


def _run(model, images):
    with torch.inference_mode():
        return model(torch.from_numpy(images)).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_carry_over_matches_flax(case):
    kind, args, size = CASES[case]
    jax_tower, port_tower, carry = kind[:3]
    jspec, pspec = _specs(kind, args)
    params = _flax_params(jax_tower, jspec, size, seed=3)
    images = _images(2, size)
    want = _jax_features(jax_tower, jspec, params, images)
    got = _run(_port(port_tower, pspec, carry(params)), images)
    assert got.shape == want.shape == (2, pspec.embedding_dim)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("case", ["resnet-basic-tiny", "resnet-bottleneck-tiny", "convnext-tiny-spec"])
def test_torchvision_state_dict_loads_as_the_jax_converter_reads_it(case):
    kind, args, size = CASES[case]
    jax_tower, port_tower, _carry, jax_convert, port_convert = kind
    jspec, pspec = _specs(kind, args)
    sd = torchvision_cnn_sd("resnet" if kind is _RESNET else "convnext", jspec, size, seed=5)
    images = _images(2, size, seed=1)
    want = _jax_features(jax_tower, jspec, jax_convert(sd, jspec), images)
    got = _run(_port(port_tower, pspec, port_convert(sd)), images)
    assert np.abs(got - want).max() <= TOL


def _patches(n=4, size=256):
    rng = np.random.default_rng(9)
    return [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("name", ["resnet18", "convnext_tiny"])
def test_zoo_pth_extract_batch_matches_jax(name, tmp_path, monkeypatch):
    jspec = jax_zoo.ENTRIES[name].spec
    sd = torchvision_cnn_sd(jax_zoo.ENTRIES[name].family, jspec, 224, seed=13)
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, tmp_path / f"{name}.pth")
    monkeypatch.setenv("ATLASPATCH_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.delenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", raising=False)
    got = zoo.build_default_registry(device="cpu").create(name).extract_batch(_patches(), batch_size=4)
    want = jax_zoo.build_default_registry(device="cpu").create(name).extract_batch(_patches(), batch_size=4)
    assert got.shape == want.shape == (4, jspec.embedding_dim)
    assert np.abs(got - want).max() <= TOL


def _count(tree) -> int:
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(tree))


@pytest.mark.parametrize("name", sorted(n for n, e in zoo.ENTRIES.items() if e.family in ("resnet", "convnext")))
def test_zoo_builds_every_cnn_name(name, monkeypatch):
    """Each name builds its tower from the registry, with the JAX tower's
    embedding dim and parameter count. The random init is swapped for a
    no-op here: it takes seconds per full-size tower on the CPU, and runs at
    small sizes in test_bfloat16_casts_every_param."""
    entry, ref = zoo.ENTRIES[name], jax_zoo.ENTRIES[name]
    assert entry.implemented and entry.family == ref.family
    tower = zoo._TOWERS[entry.family][0]
    monkeypatch.setattr(zoo, "init_random_weights_", lambda model, seed: model)
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    monkeypatch.delenv("ATLASPATCH_WEIGHTS_DIR", raising=False)
    ext = zoo.build_default_registry(device="cpu").create(name)
    assert isinstance(ext.model, tower) and ext.embedding_dim == ref.embedding_dim
    size = entry.preprocess.crop
    shapes = jax.eval_shape(lambda: jax_zoo._model_for(ref).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))["params"])
    tensors = list(ext.model.parameters()) + list(ext.model.buffers())  # BatchNorm stats are buffers
    assert sum(t.numel() for t in tensors) == _count(shapes)


@pytest.mark.parametrize("name", ["resnet50", "convnext_tiny"])
def test_bfloat16_casts_every_param(name, monkeypatch):
    entry = zoo.ENTRIES[name]
    args = ((1, 1, 1, 1), entry.spec.bottleneck) if entry.family == "resnet" else \
        ((1, 1, 1, 1), (8, 16, 24, 32))
    tiny = dataclasses.replace(entry, spec=type(entry.spec)(*args),
                               preprocess=dataclasses.replace(entry.preprocess, crop=64, resize=72))
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    monkeypatch.delenv("ATLASPATCH_WEIGHTS_DIR", raising=False)
    f32 = zoo.build_extractor(tiny, device="cpu")
    bf16 = zoo.build_extractor(tiny, device="cpu", compute_dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in bf16.model.parameters())
    assert all(b.dtype == torch.bfloat16 for b in bf16.model.buffers())
    a, b = f32.extract_batch(_patches(3, 80)), bf16.extract_batch(_patches(3, 80))
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    assert a.dtype == b.dtype == np.float32 and cos.min() > COSINE_BF16
