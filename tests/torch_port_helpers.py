"""Shared fixtures for the parity tests of the PyTorch port (tests/test_torch_*.py).

One Flax parameter tree, made from a seed, feeds both packages: the JAX model
reads it as jnp arrays, the port loads it through ``flax_to_torch``. The
Flax initializers leave the positional embeddings and the no-memory
embedding at zero, so those are filled from numpy to make parity meaningful.
"""

from __future__ import annotations

import jax
import numpy as np

from atlaspatch_tpu.models.sam2.config import SAM2Config as JaxSAM2Config
from atlaspatch_tpu.models.sam2.model import init_params as jax_init_params
from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
from atlaspatch_tpu_torch.models.sam2.convert import flax_to_torch, load_into
from atlaspatch_tpu_torch.models.sam2.model import SAM2ImageModel

JAX_CFG = JaxSAM2Config.test_tiny()
CFG = SAM2Config.test_tiny()


def shared_flax_params(seed: int = 0, cfg=JAX_CFG) -> dict:
    """Flax param tree as numpy arrays, with the zero-initialized embeddings
    randomized."""
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
