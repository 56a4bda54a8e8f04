"""The port's fused segmentation step against the JAX package's.

``segment_step_packed_to_shape`` runs on-device upscale + normalize, the SAM2
forward, the logit upscale, the threshold, the PIL-NEAREST gather and the
MSB-first pack. Both packages run it in float32 on the CPU on the same
params and thumbnails. Packed bits must agree except at pixels whose logit
lies within 1e-4 of the threshold (the model-numerics bar: the frameworks sum
in other orders, so such a pixel may round to either side); those are
counted. The host tables (PIL index, interpolation weights) must be
identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from atlaspatch_tpu.models.sam2 import interp as jax_interp
from atlaspatch_tpu.models.sam2 import model as jax_model
from atlaspatch_tpu_torch.models.sam2 import interp, model
from torch_port_helpers import JAX_CFG, port_model, shared_flax_params

NEAR = 1e-4
THRESHOLD = 0.0


@pytest.fixture(scope="module")
def params():
    return shared_flax_params(seed=5)


@pytest.fixture(scope="module")
def both(params):
    return jax.tree.map(jnp.asarray, params), port_model(params)


@pytest.mark.parametrize("shape", [(2, 40, 37), (1, 48, 64)])
def test_packed_to_shape_matches_jax(both, shape):
    jax_params, port = both
    n, h, w = shape
    rng = np.random.default_rng(h * w)
    thumbs = rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)
    S = JAX_CFG.image_size
    rows, cols = model.pil_nearest_index(h, S), model.pil_nearest_index(w, S)

    want = jax_model.segment_step_packed_to_shape(
        JAX_CFG,
        jax_params,
        jnp.asarray(thumbs),
        jnp.float32(THRESHOLD),
        jnp.asarray(rows, jnp.int32),
        jnp.asarray(cols, jnp.int32),
    )
    got = model.segment_step_packed_to_shape(
        port, torch.from_numpy(thumbs), THRESHOLD, torch.from_numpy(rows), torch.from_numpy(cols)
    )
    assert got.dtype == torch.uint8 and tuple(got.shape) == (n, h, -(-w // 8))

    got_bits = np.unpackbits(got.numpy(), axis=-1)[..., :w]
    want_bits = np.unpackbits(np.asarray(want), axis=-1)[..., :w]
    logits = model.thumbs_to_logits(port, torch.from_numpy(thumbs)).numpy()
    logits = logits[:, rows][:, :, cols]
    near = np.abs(logits - THRESHOLD) < NEAR
    differ = got_bits != want_bits
    assert not (differ & ~near).any(), f"{int((differ & ~near).sum())} bits differ away from the threshold"
    # the count of exempt pixels stays a handful, and the mask is not trivial
    assert near.sum() <= max(2, near.size // 1000), int(near.sum())
    assert 0 < got_bits.mean() < 1


def test_segment_step_logits_match_jax(both):
    jax_params, port = both
    S = JAX_CFG.image_size
    images = np.random.default_rng(9).integers(0, 256, size=(1, S, S, 3), dtype=np.uint8)
    want = jax_model.segment_step(JAX_CFG, jax_params, jnp.asarray(images))
    got = model.segment_step(port, torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=NEAR, atol=NEAR)


@pytest.mark.parametrize("n_out,n_in", [(40, 128), (37, 128), (1024, 1024), (255, 1024), (96, 512), (512, 96)])
def test_pil_nearest_index_identical(n_out, n_in):
    np.testing.assert_array_equal(
        model.pil_nearest_index(n_out, n_in), jax_model.pil_nearest_index(n_out, n_in)
    )


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("in_size,out_size", [(7, 64), (7, 48), (40, 128), (256, 1024), (37, 24)])
def test_interp_weights_identical(mode, in_size, out_size):
    got = interp._interp_weights_1d(in_size, out_size, mode)
    want = jax_interp._interp_weights_1d(in_size, out_size, mode)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_interpolate_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 7, 9, 3)).astype(np.float32)
    got = interp.interpolate_torch(torch.from_numpy(x), (32, 40), "bicubic").numpy()
    want = np.asarray(jax_interp.interpolate_torch(jnp.asarray(x), (32, 40), "bicubic"))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_packbits_msb_first():
    bits = np.random.default_rng(3).integers(0, 2, size=(3, 5, 24), dtype=np.uint8)
    got = model._packbits_last_axis(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(got, np.packbits(bits, axis=-1))
    one = np.zeros((1, 8), np.uint8)
    one[0, 0] = 1  # first pixel → most significant bit
    assert model._packbits_last_axis(torch.from_numpy(one)).item() == 128
