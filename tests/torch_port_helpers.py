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
