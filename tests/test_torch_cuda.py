"""The port's CUDA attention kernel on the card (skips without one).

Imports neither JAX nor the JAX package, so it also runs where only the port
is installed. Run it on a machine with an H100 and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.) Each kernel body is
held against the plain version on the same inputs, computed in float32 on the
card (TF32 off): for float32 inputs max-abs 1e-4 and, element by element,
``f32_error_limit`` (the 3xTF32 body's split products; the FMA and
small-window bodies round only in float32); for bfloat16 max-abs
2e-2 and, element by element, ``bf16_error_limit`` (the kernel rounds p and
its float32 result to bfloat16; inputs are unit-normal). The cases that
name a body assert which one launched, by the wrapper's per-variant counts.
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


def _assert_close(got, q, k, v, sm_scale=None):
    """got against the plain version in float32, as the docstring says."""
    error_limit = A.f32_error_limit if got.dtype == torch.float32 else A.bf16_error_limit
    want, limit = error_limit(q, k, v, sm_scale)
    err = (got.float() - want).abs()
    assert err.max().item() <= TOL[got.dtype]
    assert (err <= limit).all(), f"max err/limit {(err / limit).max().item()}"


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
    _assert_close(got, q, k, v)


def _launched(fn):
    """The result of fn() and the variant it launched, by the wrapper's counts."""
    before = dict(A.flash_attention.variant_launches)
    out = fn()
    after = dict(A.flash_attention.variant_launches)
    (variant,) = [k for k in after if after[k] != before.get(k, 0)]
    return out, variant


WGMMA_CASES = [
    ((1, 4, 2304, 2304, 96), "wgmma_m192"),  # the global block at small B*H
    *[((1, 2, tq, tk, 96), v) for tq, v in ((63, "wgmma_m64"), (64, "wgmma_m64"), (65, "wgmma_m128"),
                                            (129, "wgmma_m192")) for tk in (127, 128, 129)],  # tile edges
    ((2, 4, 49, 49, 96), "wgmma_m64"),  # stage-3 window: ragged 49-row tiles
    ((2, 4, 196, 196, 96), "wgmma_m128"),  # stage-2 window: 196 = 128 + 68 keys
    ((2, 4, 49, 196, 96), "wgmma_m64"),  # q-pool from 14x14 windows
    ((1, 2, 200, 300, 64), "wgmma_m128"),
    ((1, 2, 384, 300, 64), "wgmma_m192"),
    ((1, 2, 200, 300, 128), "wgmma_m128"),
    ((2, 2, 40, 100, 64), "wgmma_m64"),
    ((2, 2, 40, 100, 128), "wgmma_m64"),
]


@pytest.mark.parametrize("shape,variant", WGMMA_CASES)
def test_wgmma_body_matches_plain(card, shape, variant):
    """bfloat16 with D in {64, 96, 128} and T_q > 16 launches the wgmma body."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.bfloat16)
    got, launched = _launched(lambda: A.flash_attention(q, k, v))
    torch.cuda.synchronize()
    assert launched == variant
    _assert_close(got, q, k, v)


@pytest.mark.parametrize("variant", ["mma", "wgmma_m64", "wgmma_m128", "wgmma_m192"])
@pytest.mark.parametrize("shape", [(2, 4, 64, 64, 96), (2, 4, 196, 196, 96), (1, 1, 17, 300, 64)])
def test_every_bf16_body_agrees(card, shape, variant):
    """Launched on any body that fits the inputs, the result is the same function."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.bfloat16, seed=3)
    got, launched = _launched(lambda: A._launch(variant, q, k, v))
    torch.cuda.synchronize()
    assert launched == variant
    _assert_close(got, q, k, v)


@pytest.mark.parametrize("variant", ["mma", "wgmma_m64", "wgmma_m128", "wgmma_m192"])
@pytest.mark.parametrize("shape", [(1, 2, 196, 196, 96), (2, 2, 49, 300, 64)])
def test_negative_scale(card, shape, variant):
    """A negative scale reverses the order of the scores; on ragged K/V tiles
    the masked keys must still get no weight (the wgmma body applies the scale
    before the mask)."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.bfloat16, seed=4)
    got, launched = _launched(lambda: A._launch(variant, q, k, v, -0.125))
    torch.cuda.synchronize()
    assert launched == variant and torch.isfinite(got).all()
    _assert_close(got, q, k, v, -0.125)


TF32X3_SHAPES = [(2, 4, 64, 64, 96), (2, 4, 196, 196, 96), (1, 1, 17, 300, 64)]


@pytest.mark.parametrize("sm_scale", [None, -0.125])
@pytest.mark.parametrize("shape", TF32X3_SHAPES)
def test_tf32x3_body_matches_plain(card, shape, sm_scale):
    """float32 with D in {64, 96}, T_q > 16 and a window past 64 rows launches
    the 3xTF32 body (the 64/64 window, which f32_win takes, forces it); a
    negative scale reverses the scores, and the masked keys of a ragged tile
    must still get no weight."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.float32, seed=5)
    if A.kernel_variant(torch.float32, tq, tk, d) == "tf32x3":
        got, launched = _launched(lambda: A.flash_attention(q, k, v, sm_scale))
    else:
        got, launched = _launched(lambda: A._launch("tf32x3", q, k, v, sm_scale))
    torch.cuda.synchronize()
    assert launched == "tf32x3" and torch.isfinite(got).all()
    _assert_close(got, q, k, v, sm_scale)


@pytest.mark.parametrize("shape", TF32X3_SHAPES)
def test_float32_bodies_agree(card, shape):
    """The FMA and the 3xTF32 body, forced on the same inputs, agree."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.float32, seed=6)
    fma, fma_variant = _launched(lambda: A._launch("f32", q, k, v))
    tc, tc_variant = _launched(lambda: A._launch("tf32x3", q, k, v))
    torch.cuda.synchronize()
    assert (fma_variant, tc_variant) == ("f32", "tf32x3")
    assert (fma - tc).abs().max().item() <= TOL[torch.float32]
    _assert_close(fma, q, k, v)
    _assert_close(tc, q, k, v)


@pytest.mark.parametrize(
    "dtype,d,variant,error",
    [
        (torch.bfloat16, 72, "wgmma_m128", RuntimeError),  # the library builds D 64/96/128
        (torch.bfloat16, 128, "wgmma_m192", RuntimeError),  # and 192 rows only to D = 96
        (torch.float32, 96, "wgmma_m64", ValueError),
        (torch.float32, 96, "mma", ValueError),
        (torch.bfloat16, 96, "tf32x3", ValueError),
        (torch.float32, 128, "tf32x3", RuntimeError),  # built for D = 64 and 96 only
        (torch.bfloat16, 96, "f32_win", ValueError),
        (torch.float32, 96, "f32_win", ValueError),  # T_q = T_kv = 128 > 64
    ],
)
def test_forced_variant_refused(card, dtype, d, variant, error):
    q, k, v = _qkv(card, 1, 1, 128, 128, d, dtype)
    with pytest.raises(error, match="variant|cudaError 1"):
        A._launch(variant, q, k, v)


def test_launch_count_and_non_contiguous_inputs(card):
    q, k, v = _qkv(card, 1, 2, 70, 70, 32, torch.float32)
    before = A.flash_attention.launches
    got = A.attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    assert A.flash_attention.launches == before + 1
    _assert_close(got, q, k, v)


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
    got, variant = _launched(lambda: A.flash_attention(q, k, v))
    torch.cuda.synchronize()
    assert variant == ("wgmma_m192" if dtype == torch.bfloat16 else "tf32x3")
    assert got.shape == (b, h, t, d) and got.transpose(1, 2).is_contiguous()
    _assert_close(got, q, k, v)


# (B, H, T_q, T_kv, D): the float32 default's five window shapes at small B*H,
# ragged T_q and T_kv, and head dims off the Hiera width.
F32WIN_SHAPES = [
    (2, 1, 64, 64, 96),  # stage-0 window
    (2, 2, 16, 64, 96),  # q-pool from 8x8 windows
    (2, 2, 16, 16, 96),  # stage-1 window
    (2, 4, 4, 16, 96),  # q-pool from 4x4 windows
    (2, 4, 49, 49, 96),  # stage-3 window
    *[(1, 3, tq, tk, 96) for tq in (1, 9, 49) for tk in (1, 17, 63, 64)],
    *[(2, 2, 33, 40, d) for d in (8, 40, 128)],
    (67, 3, 4, 16, 96),  # more heads than a stage's units, a ragged last group
]


@pytest.mark.parametrize("sm_scale", [None, -0.125])
@pytest.mark.parametrize("shape", F32WIN_SHAPES)
def test_f32win_body_matches_plain(card, shape, sm_scale):
    """float32 with T_q and T_kv up to 64, where the 3xTF32 body does not take
    it, launches the small-window body (the other shapes force it); a negative
    scale reverses the scores, and the keys past T_kv must still get no
    weight."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.float32, seed=7)
    if A.kernel_variant(torch.float32, tq, tk, d) == "f32_win":
        got, launched = _launched(lambda: A.flash_attention(q, k, v, sm_scale))
    else:
        got, launched = _launched(lambda: A._launch("f32_win", q, k, v, sm_scale))
    torch.cuda.synchronize()
    assert launched == "f32_win" and torch.isfinite(got).all()
    _assert_close(got, q, k, v, sm_scale)


@pytest.mark.parametrize(
    "shape", [(2, 4, 64, 64, 96), (2, 4, 49, 49, 96), (2, 2, 16, 64, 96), (1, 2, 33, 40, 64),
              (2, 2, 20, 64, 128)]
)
def test_f32win_agrees_with_the_other_float32_bodies(card, shape):
    """f32_win, the FMA body and (D 64/96, T_q > 16) the 3xTF32 body, forced
    on the same inputs, agree."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.float32, seed=8)
    bodies = ["f32_win", "f32"] + (["tf32x3"] if d in A.TF32X3_HEAD_DIMS and tq > 16 else [])
    outs = {}
    for body in bodies:
        outs[body], launched = _launched(lambda: A._launch(body, q, k, v))
        assert launched == body
    torch.cuda.synchronize()
    for body in bodies[1:]:
        assert (outs["f32_win"] - outs[body]).abs().max().item() <= TOL[torch.float32]
    for out in outs.values():
        _assert_close(out, q, k, v)


@pytest.mark.parametrize("tq,tk", [(16, 65), (65, 16), (65, 65)])
def test_f32win_refuses_longer_windows(card, tq, tk):
    q, k, v = _qkv(card, 1, 2, tq, tk, 96, torch.float32)
    with pytest.raises(ValueError, match="f32_win"):
        A._launch("f32_win", q, k, v)


@pytest.mark.parametrize("tq", [4, 16])
def test_f32win_reads_a_fused_projection_in_place(card, tq):
    """q, k, v as a window of the trunk hands them over (the stage-1 window:
    16 rows): views of one (B, T, 3, H, D) projection, rows 3 H D floats
    apart, read without a copy."""
    b, h, d = 3, 2, 96
    gen = torch.Generator(device=card).manual_seed(2)
    qkv = torch.randn(b, tq, 3, h, d, device=card, generator=gen)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    assert all(A._kernel_readable(t) is t for t in (q, k, v))
    got, variant = _launched(lambda: A.flash_attention(q, k, v))
    torch.cuda.synchronize()
    assert variant == "f32_win"
    assert got.shape == (b, h, tq, d) and got.transpose(1, 2).is_contiguous()
    _assert_close(got, q, k, v)


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
