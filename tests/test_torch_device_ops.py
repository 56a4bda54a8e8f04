"""The port's leftover device ops against the JAX package's, on the CPU.

``ops/filters.py``: ``content_filter_mask`` (and its host wrapper) equals the
JAX package's and the host ``utils.image`` decision, on random and edge
batches; ``gray_u8`` and ``sat_val_u8`` equal the JAX ones pixel for pixel.
``ops/resize.py``: ``resize_nearest`` equals the JAX one for up and down
ratios, among them 1000 → 768, 7 → 3 and ratios where a float64 index would
differ; the re-exported interpolation is the SAM2 path's. Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlaspatch_tpu.ops import filters as jf
from atlaspatch_tpu.ops import resize as jr
from atlaspatch_tpu_torch.models.sam2.interp import interpolate_torch
from atlaspatch_tpu_torch.ops import filters as pf
from atlaspatch_tpu_torch.ops import resize as pr
from atlaspatch_tpu_torch.utils.image import is_black_patch, is_white_patch

THRESHOLDS = [(50, 15), (40, 5), (128, 50)]


def _batch(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    patches = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(12)]
    patches.append(np.zeros((32, 32, 3), np.uint8))  # black
    patches.append(np.full((32, 32, 3), 250, np.uint8))  # white
    dark = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    dark.reshape(-1, 3)[: int(0.7 * 1024)] = 0  # exactly at the 0.7 fraction, and just under
    patches.append(dark)
    dark2 = dark.copy()
    dark2.reshape(-1, 3)[int(0.7 * 1024)] = 255
    patches.append(dark2)
    pale = np.full((32, 32, 3), 230, np.uint8)
    pale[..., 0] = rng.integers(200, 256, (32, 32), dtype=np.uint8)  # the saturation edge
    patches.append(pale)
    patches.append(np.stack([np.arange(256, dtype=np.uint8).reshape(16, 16)] * 3, -1).repeat(2, 0).repeat(2, 1))
    return np.stack(patches)


@pytest.mark.parametrize("seed", [0, 1])
def test_gray_and_sat_val_match_jax(seed):
    batch = _batch(seed)
    np.testing.assert_array_equal(pf.gray_u8(torch.from_numpy(batch)).numpy(),
                                  np.asarray(jf.gray_u8(jnp.asarray(batch))))
    got_s, got_v = pf.sat_val_u8(torch.from_numpy(batch))
    want_s, want_v = jf.sat_val_u8(jnp.asarray(batch))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_s.dtype == got_v.dtype == torch.uint8


@pytest.mark.parametrize("rgb_t,sat_t", THRESHOLDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_content_filter_mask_matches_jax_and_host(seed, rgb_t, sat_t):
    batch = _batch(seed)
    got = pf.content_filter_mask_host(batch, device="cpu", rgb_thresh=rgb_t, sat_thresh=sat_t)
    want = jf.content_filter_mask_host(batch, rgb_thresh=rgb_t, sat_thresh=sat_t)
    host = np.array([not is_black_patch(p, rgb_thresh=rgb_t) and not is_white_patch(p, sat_thresh=sat_t)
                     for p in batch])
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, host)
    assert got.any() and not got.all()


def test_content_filter_mask_keyword_defaults_and_fractions():
    batch = _batch(2)
    for kw in ({}, {"value_thresh": 240, "min_fraction": 0.5}, {"min_fraction": 0.7001}):
        got = pf.content_filter_mask(torch.from_numpy(batch), **kw).numpy()
        np.testing.assert_array_equal(got, np.asarray(jf.content_filter_mask(jnp.asarray(batch), **kw)))


@pytest.mark.parametrize("hw,out", [((1000, 1000), (768, 768)), ((7, 7), (3, 3)), ((3, 5), (7, 11)),
                                    ((768, 1000), (1000, 768)), ((2, 2), (41, 47)), ((97, 61), (50, 61)),
                                    ((5, 4), (5, 4))])
@pytest.mark.parametrize("channels", [None, 3])
def test_resize_nearest_matches_jax(hw, out, channels):
    rng = np.random.default_rng(sum(hw) + sum(out))
    shape = (2, *hw) + (() if channels is None else (channels,))
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    got = pr.resize_nearest(torch.from_numpy(x), out).numpy()
    want = np.asarray(jr.resize_nearest(jnp.asarray(x), out))
    assert got.shape == want.shape == (2, *out) + shape[3:]
    np.testing.assert_array_equal(got, want)


def test_resize_nearest_indexes_in_float32():
    """At 2 → 41 a float64 index differs from the float32 one; the port
    follows the reference's float32."""
    f64 = np.clip(((np.arange(41) + 0.5) * (2 / 41)).astype(np.int32), 0, 1)
    x = torch.arange(2).reshape(1, 2, 1).expand(1, 2, 2).contiguous()
    got = pr.resize_nearest(x, (41, 2))[0, :, 0].numpy()
    want = np.asarray(jr.resize_nearest(jnp.asarray(x.numpy()), (41, 2)))[0, :, 0]
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, f64)


def test_resize_reexports_the_interpolation():
    assert pr.interpolate_torch is interpolate_torch
    assert jr.interpolate_torch.__name__ == pr.interpolate_torch.__name__
