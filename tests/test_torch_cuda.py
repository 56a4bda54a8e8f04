"""The port's CUDA attention kernel on the card (skips without one).

Imports neither JAX nor the JAX package, so it also runs where only the port
is installed. Run it on a machine with an H100 and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.) The kernel is held
against the plain version on the same inputs, computed in float32 on the
card: max-abs 1e-4 for float32 inputs, 2e-2 for bfloat16 (the kernel rounds
its float32 result to bfloat16; inputs are unit-normal).
"""

import pytest
import torch

from atlaspatch_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(card, b, h, tq, tk, d, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(b, h, tq, d, device=card, generator=gen).to(dtype)
    k = torch.randn(b, h, tk, d, device=card, generator=gen).to(dtype)
    v = torch.randn(b, h, tk, d, device=card, generator=gen).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    [
        (2, 1, 64, 64, 96),  # stage-0 window
        (2, 4, 4, 16, 96),  # q-pool from 4x4 windows
        (4, 2, 16, 64, 96),  # q-pool from 8x8 windows
        (1, 3, 9, 200, 24),  # one-warp Q tile over several ragged K/V tiles
        (2, 4, 49, 196, 96),  # q-pool from 14x14 windows
        (2, 1, 196, 196, 96),  # ragged window
        (1, 4, 300, 300, 96),  # ragged global
        (1, 2, 130, 70, 8),
        (1, 2, 65, 129, 40),
        (1, 1, 128, 128, 128),
    ],
)
def test_kernel_matches_plain(card, dtype, shape):
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, dtype)
    got = A.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    want = A.reference_attention(q.float(), k.float(), v.float())
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


def test_launch_count_and_non_contiguous_inputs(card):
    q, k, v = _qkv(card, 1, 2, 70, 70, 32, torch.float32)
    before = A.flash_attention.launches
    got = A.attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    assert A.flash_attention.launches == before + 1
    want = A.reference_attention(q, k, v)
    assert (got - want).abs().max().item() <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("misaligned", [False, True])
def test_strided_views_of_a_fused_projection(card, dtype, misaligned):
    """q, k, v as the trunk hands them over: views of one (B, T, 3, H, D)
    projection, read in place; a view whose rows are not on 16 bytes is
    copied first. The output is a (B, H, T, D) view of (B, T, H, D)."""
    b, t, h, d = 3, 130, 2, 96
    gen = torch.Generator(device=card).manual_seed(1)
    wide = torch.randn(b, t, 3 * h * d + 8, device=card, generator=gen).to(dtype)
    start = 1 if misaligned else 0
    qkv = wide[..., start : start + 3 * h * d].unflatten(-1, (3, h, d))
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    got = A.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (b, h, t, d) and got.transpose(1, 2).is_contiguous()
    want = A.reference_attention(q.float(), k.float(), v.float())
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize(
    "kind", ["head_dim_100", "head_dim_136", "float16", "mixed_dtype", "cpu_key"]
)
def test_kernel_refuses(card, kind):
    d = {"head_dim_100": 100, "head_dim_136": 136}.get(kind, 64)
    dtype = torch.float16 if kind == "float16" else torch.float32
    q, k, v = _qkv(card, 1, 1, 16, 16, d, dtype)
    if kind == "mixed_dtype":
        k = k.to(torch.bfloat16)
    if kind == "cpu_key":
        k = k.cpu()
    with pytest.raises(ValueError):
        A.flash_attention(q, k, v)
