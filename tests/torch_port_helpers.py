"""Shared fixtures for the parity tests of the PyTorch port (tests/test_torch_*.py).

One Flax parameter tree, made from a seed, feeds both packages: the JAX model
reads it as jnp arrays, the port loads it through ``flax_to_torch``. The
Flax initializers leave the positional embeddings and the no-memory
embedding at zero, so those are filled from numpy to make parity meaningful.
"""

from __future__ import annotations

import functools
import shutil

import jax
import numpy as np
import pytest

from atlaspatch_tpu.models.sam2.config import SAM2Config as JaxSAM2Config
from atlaspatch_tpu.models.sam2.model import init_params as jax_init_params
from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
from atlaspatch_tpu_torch.models.sam2.convert import flax_to_torch, load_into
from atlaspatch_tpu_torch.models.sam2.model import SAM2ImageModel

JAX_CFG = JaxSAM2Config.test_tiny()
CFG = SAM2Config.test_tiny()


@pytest.fixture(autouse=True)
def free_tmp_path(request):
    """Autouse in the modules that import it (the ones that write
    checkpoints): once a test that asked for ``tmp_path`` is done, its
    directory goes, with every checkpoint and archive the test wrote and
    read there, so a run leaves no weights behind in pytest's temp root.
    Module fixtures of those modules made with ``tmp_path_factory`` remove
    their own directories when the module is done."""
    path = request.getfixturevalue("tmp_path") if "tmp_path" in request.fixturenames else None
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def shared_flax_params(seed: int = 0, cfg=JAX_CFG) -> dict:
    """Flax param tree as numpy arrays, with the zero-initialized embeddings
    randomized: a fresh copy of each call's tree, which the JAX init (~15 s
    on the CPU) makes once per process."""
    return jax.tree.map(np.copy, _shared_flax_params(seed, cfg))


@functools.lru_cache(maxsize=4)
def _shared_flax_params(seed: int, cfg) -> dict:
    params = jax.tree.map(np.asarray, jax_init_params(cfg, seed))
    rng = np.random.default_rng(seed + 1)
    bb = params["backbone"]
    for name in ("pos_embed", "pos_embed_window"):
        bb[name] = rng.normal(0.0, 0.5, bb[name].shape).astype(np.float32)
    params["no_memory_embedding"] = rng.normal(
        0.0, 0.5, params["no_memory_embedding"].shape
    ).astype(np.float32)
    return params


def shared_vit_params(spec, seed: int = 0) -> dict:
    """Flax-initialized params of the JAX ViT of ``spec`` as numpy arrays, with
    N(0, 0.05) noise added to every leaf (so zero-initialized tokens, biases
    and unit LayerNorms carry values)."""
    import jax.numpy as jnp

    from atlaspatch_tpu.models.encoders.vit import ViT as JaxViT

    dummy = jnp.zeros((1, spec.img_size, spec.img_size, 3), jnp.float32)
    init = jax.jit(lambda key: JaxViT(spec).init(key, dummy)["params"])
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda a: (a + rng.normal(0.0, 0.05, a.shape)).astype(np.float32), params)


def port_model(params: dict, cfg=CFG) -> SAM2ImageModel:
    """The port's float32 CPU model holding ``params``."""
    model = SAM2ImageModel(cfg)
    load_into(model, flax_to_torch(params, cfg))
    return model.eval()


def h5_view(path, skip=("creation_date",)) -> tuple[dict, dict]:
    """What h5py reads from an H5 file: {dataset: (dtype, shape, bytes)} and
    {attr: (python type, dtype or None, value)}, leaving out the attrs named
    in ``skip``."""
    import h5py

    with h5py.File(path, "r") as f:
        datasets = {}
        for name, obj in f.items():
            assert isinstance(obj, h5py.Dataset), name
            arr = obj[()]
            datasets[name] = (arr.dtype, arr.shape, arr.tobytes())
        attrs = {}
        for key in f.attrs:
            if key in skip:
                continue
            value = f.attrs[key]
            attrs[key] = (type(value), getattr(value, "dtype", None), value)
    return datasets, attrs


def assert_creation_dates_utc(*paths) -> None:
    """Each file's creation_date attr parses as an ISO-8601 time in UTC."""
    from datetime import datetime, timedelta

    import h5py

    for path in paths:
        with h5py.File(path, "r") as f:
            stamp = f.attrs["creation_date"]
        assert isinstance(stamp, str)
        assert datetime.fromisoformat(stamp).utcoffset() == timedelta(0)


# ------------------------------------------------------------ slide readers
def outcome(fn):
    """fn()'s result, or ("raised", exception type name, message)."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — the refusal itself is compared
        return ("raised", type(e).__name__, str(e))


def _bounded(w: int, h: int, cap: int = 1024) -> tuple[int, int]:
    return max(1, min(w, cap)), max(1, min(h, cap))


def native_tiff_record(tiff_file_cls, path) -> dict:
    """Everything a native pyramid file exposes: levels, properties, and the
    pixels of whole-level, interior, edge and IDCT-scaled reads (each read's
    refusal recorded in its place)."""
    f = outcome(lambda: tiff_file_cls(str(path)))
    if isinstance(f, tuple):
        return {"open": f}
    rec = {
        "levels": f.level_count,
        "dims": f.level_dimensions,
        "ds": f.level_downsamples,
        "props": f.properties,
    }
    for lv, (w, h) in enumerate(f.level_dimensions):
        bw, bh = _bounded(w, h)
        read = f.read_region_level
        rec[lv, "whole"] = outcome(lambda: read(lv, 0, 0, bw, bh))
        rec[lv, "inner"] = outcome(lambda: read(lv, w // 3, h // 3, 97, 61))
        rec[lv, "edge"] = outcome(lambda: read(lv, w - 40, h - 30, 64, 64))
        scaled = f.read_region_level_scaled
        for s in (2, 3, 4, 8):
            rec[lv, "scaled", s] = outcome(lambda: scaled(lv, 0, 0, bw, bh, s))
            rec[lv, "scaled-sub", s] = outcome(lambda: scaled(lv, 64, 64, 128, 128, s))
        rec[lv, "scaled-off-grid"] = outcome(lambda: scaled(lv, 3, 0, 64, 64, 4))
    f.close()
    return rec


def wsi_record(wsi_cls, path, mpp=None) -> dict:
    """What the runner and the embedder read from an IWSI reader: geometry,
    mpp / magnification / metadata, thumbnails and level reads."""
    wsi = outcome(lambda: wsi_cls(path=str(path), mpp=mpp))
    opened = wsi if isinstance(wsi, tuple) else outcome(wsi._ensure_loaded)
    if isinstance(opened, tuple):
        return {"open": opened}
    rec = {
        "size": (wsi.w, wsi.h),
        "levels": wsi.nlvl,
        "dims": [tuple(d) for d in wsi.dims],
        "ds": list(wsi.ds),
        "mpp": wsi.mpp,
        "mag": wsi.mag,
        "meta": wsi.meta,
        "attrs": outcome(wsi.metadata_attrs),
        "thumb": outcome(lambda: np.asarray(wsi.get_thumb((96, 96)))),
        "power": outcome(lambda: np.asarray(wsi.get_thumbnail_at_power(power=1.25))),
        "power-scaled": outcome(
            lambda: np.asarray(wsi.get_thumbnail_at_power(power=1.25, scaled_decode=True))
        ),
    }
    for lv in range(wsi.nlvl):
        rec["extract", lv] = outcome(lambda: wsi.extract((wsi.w // 4, wsi.h // 4), lv, (80, 72)))
        rec["extract-edge", lv] = outcome(lambda: wsi.extract((wsi.w - 50, wsi.h - 40), lv, (64, 64)))
        rec["extract-scaled", lv] = outcome(lambda: wsi.extract_scaled((0, 0), lv, _bounded(*wsi.dims[lv]), 4))
    wsi.cleanup()
    return rec


def assert_same_record(want, got, where: str = "") -> None:
    """Deep equality; arrays must agree in dtype, shape and every byte."""
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        assert isinstance(want, np.ndarray) and isinstance(got, np.ndarray), where
        assert (want.dtype, want.shape) == (got.dtype, got.shape), where
        assert want.tobytes() == got.tobytes(), where
    elif isinstance(want, dict):
        assert isinstance(got, dict) and want.keys() == got.keys(), where
        for key in want:
            assert_same_record(want[key], got[key], f"{where}/{key}")
    elif isinstance(want, (list, tuple)):
        assert type(want) is type(got) and len(want) == len(got), (where, want, got)
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same_record(a, b, f"{where}[{i}]")
    else:
        assert type(want) is type(got) and want == got, (where, want, got)


# ------------------------------------------------------------ command lines
CLI_PACKAGES = ("atlaspatch_tpu", "atlaspatch_tpu_torch")


def write_png_slides(root, seeds: dict, mpp: dict):
    """``{stem: canvas seed}`` as 768x512 PNG slides under ``root/slides``,
    and an MPP CSV listing the stems in ``mpp`` (a stem left out has no MPP);
    returns (slide dir, csv path)."""
    from pathlib import Path

    from PIL import Image

    from atlaspatch_tpu_torch.io.synthetic_wsi import make_tissue_canvas

    root = Path(root)
    slides = root / "slides"
    slides.mkdir()
    for stem, seed in seeds.items():
        Image.fromarray(make_tissue_canvas(768, 512, seed=seed, n_blobs=2)).save(slides / f"{stem}.png")
    csv = root / "mpp.csv"
    csv.write_text("wsi,mpp\n" + "".join(f"{stem}.png,{v}\n" for stem, v in mpp.items()))
    return slides, csv


def shared_cli_weights(mp, root) -> None:
    """Both packages' SAM2 at the miniature config, both reading one weight
    archive (the JAX package's ``.npz`` format, shared_flax_params(0)) from
    ATLASPATCH_WEIGHTS_DIR; no random-weights fallback, no other checkpoint."""
    from pathlib import Path

    from atlaspatch_tpu.tools.convert_weights import _flatten

    weights = Path(root) / "weights"
    weights.mkdir()
    np.savez(weights / "sam2_hiera_tiny.npz", **_flatten(shared_flax_params(0)))
    mp.setattr(JaxSAM2Config, "tiny", JaxSAM2Config.test_tiny)
    mp.setattr(SAM2Config, "tiny", SAM2Config.test_tiny)
    mp.setenv("ATLASPATCH_WEIGHTS_DIR", str(weights))
    mp.setenv("HF_HOME", str(Path(root) / "empty-hf"))
    for var in ("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "ATLASPATCH_SAM2_CHECKPOINT", "ATLASPATCH_HOST_RESIZE",
                "ATLASPATCH_TORCH_TRACE", "ATLASPATCH_JAX_TRACE"):
        mp.delenv(var, raising=False)


def key_bias_mask(key: str, shape: tuple) -> np.ndarray:
    """The elements of a Flax SAM2 tensor that are a key bias: all of a
    ``k_proj`` bias, the middle third of a Hiera ``qkv`` bias. Softmax over
    the keys does not change when one vector is added to every key, so their
    exact gradient is zero and what backward gives is rounding noise, which
    AdamW turns into steps of the learning rate of either sign."""
    mask = np.zeros(shape, bool)
    if key.endswith("k_proj/bias"):
        mask[:] = True
    elif key.endswith("qkv/bias"):
        n = shape[-1] // 3
        mask[..., n : 2 * n] = True
    return mask


def invoke_cli(pkg: str, args, **kw):
    """``pkg``'s click group on ``args`` in this process (click.testing)."""
    import importlib

    from click.testing import CliRunner

    cli = importlib.import_module(f"{pkg}.cli").cli
    return CliRunner().invoke(cli, [str(a) for a in args], **kw)


def stdout_lines(result, out) -> list[str]:
    """The command's stdout lines, with the output root written as <out>."""
    return result.stdout.replace(str(out), "<out>").splitlines()


def png_array(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


# ------------------------------------------------------------ CNN encoders
def torchvision_cnn_sd(family: str, jax_spec, size: int = 224, seed: int = 0) -> dict:
    """A torchvision-layout ResNet or ConvNeXt state_dict of ``jax_spec``,
    every tensor drawn from numpy: kernels N(0, 1/fan_in), scales /
    variances / layer scales in [0.5, 1.5], the rest N(0, 0.1); the
    ``fc`` / ``classifier`` head and BatchNorm ``num_batches_tracked``
    counters included, as torchvision saves them."""
    import math

    import jax.numpy as jnp
    import torch

    from atlaspatch_tpu.models.encoders.convnext import ConvNeXt
    from atlaspatch_tpu.models.encoders.resnet import ResNet
    from tests.upstream_layouts import torchvision_convnext_sd, torchvision_resnet_sd

    tower, make_sd = (ResNet, torchvision_resnet_sd) if family == "resnet" else \
        (ConvNeXt, torchvision_convnext_sd)
    shapes = jax.eval_shape(lambda: tower(jax_spec).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))["params"])
    rng = np.random.default_rng(seed)
    sd = {}
    for key, zero in make_sd(jax_spec, shapes).items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("running_var", "layer_scale") or (leaf == "weight" and zero.ndim == 1):
            value = rng.uniform(0.5, 1.5, zero.shape)
        elif zero.ndim >= 2:
            value = rng.normal(0.0, math.sqrt(1.0 / np.prod(zero.shape[1:])), zero.shape)
        else:
            value = rng.normal(0.0, 0.1, zero.shape)
        sd[key] = torch.from_numpy(value.astype(np.float32))
        if leaf == "running_mean":
            sd[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(11)
    if family == "convnext":  # torchvision's classifier: LayerNorm2d + Flatten + Linear
        dim = jax_spec.embedding_dim
        sd.update({"classifier.0.weight": torch.ones(dim), "classifier.0.bias": torch.zeros(dim),
                   "classifier.2.weight": torch.zeros(1000, dim), "classifier.2.bias": torch.zeros(1000)})
    return sd
