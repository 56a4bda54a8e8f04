"""The port's attention against the JAX package's on the CPU.

On CPU tensors the port's ``attention`` runs its plain version, which is held
against the JAX ``reference_attention`` and against the Pallas
``_flash_kernel`` run in interpret mode (as tests/test_flash_attention.py
runs it), in float32 at rtol/atol 2e-5. The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from atlaspatch_tpu.ops import attention as A
from atlaspatch_tpu_torch.ops import attention as port_attention

TOL = 2e-5


def _pallas_interpret(q, k, v, sm_scale, block_q=128, block_k=128):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    out = pl.pallas_call(
        functools.partial(A._flash_kernel, block_k=block_k, sm_scale=sm_scale),
        grid=(B * H, Tq // block_q),
        in_specs=[
            pl.BlockSpec((None, block_q, D), lambda b, i: (b, i, 0)),
            pl.BlockSpec((None, Tk, D), lambda b, i: (b, 0, 0)),
            pl.BlockSpec((None, Tk, D), lambda b, i: (b, 0, 0)),
        ],
        out_specs=pl.BlockSpec((None, block_q, D), lambda b, i: (b, i, 0)),
        out_shape=jax.ShapeDtypeStruct((B * H, Tq, D), q.dtype),
        interpret=True,
    )(q.reshape(B * H, Tq, D), k.reshape(B * H, Tk, D), v.reshape(B * H, Tk, D))
    return out.reshape(B, H, Tq, D)


def _qkv(q_shape, kv_len, seed=0):
    rng = np.random.default_rng(seed)
    B, H, _, D = q_shape
    q = rng.standard_normal(q_shape).astype(np.float32)
    k = rng.standard_normal((B, H, kv_len, D)).astype(np.float32)
    v = rng.standard_normal((B, H, kv_len, D)).astype(np.float32)
    return q, k, v


CASES = [((1, 2, 256, 64), 256), ((2, 4, 512, 96), 512), ((1, 2, 128, 96), 384)]


@pytest.mark.parametrize("q_shape,kv_len", CASES)
def test_plain_attention_matches_jax_reference(q_shape, kv_len):
    q, k, v = _qkv(q_shape, kv_len)
    scale = q_shape[-1] ** -0.5
    got = port_attention.attention(*map(torch.from_numpy, (q, k, v)), sm_scale=scale)
    want = A.reference_attention(*map(jnp.asarray, (q, k, v)), sm_scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("q_shape,kv_len", CASES)
def test_plain_attention_matches_pallas_kernel(q_shape, kv_len):
    q, k, v = _qkv(q_shape, kv_len, seed=1)
    scale = q_shape[-1] ** -0.5
    got = port_attention.attention(*map(torch.from_numpy, (q, k, v)), sm_scale=scale)
    want = _pallas_interpret(*map(jnp.asarray, (q, k, v)), sm_scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_cpu_dispatch_takes_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 49, 96), 196, seed=2))
    before = port_attention.flash_attention.launches
    got = port_attention.attention(q, k, v)
    torch.testing.assert_close(got, port_attention.reference_attention(q, k, v), rtol=0, atol=0)
    assert port_attention.flash_attention.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = map(torch.from_numpy, _qkv((1, 1, 64, 96), 64))
    with pytest.raises(ValueError, match="CUDA"):
        port_attention.flash_attention(q, k, v)
