"""Which attention kernel the port launches, what the wgmma body's TMA maps are
handed, and the limits the bodies are held to.

CPU only: ``kernel_variant`` and the stride rules are pure Python, so they are
held here at every shape the main path hands the kernel (Hiera-tiny, the
``--fast`` preset and the float32 default) and on the q/k/v views that the
trunk's attention hands over. ``bf16_error_limit`` is held against a bfloat16
body emulated in float64, sound and with planted faults; ``f32_error_limit``
against the 3xTF32 body emulated in float64 (TF32 rounding by bit mask,
small * small dropped) and against one uncompensated TF32 pass; the
small-window body's float32 arithmetic, emulated in float32, against the JAX
package's reference at the float32 default's window shapes. The kernels
themselves are held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch

from atlaspatch_tpu_torch.models.sam2 import hiera
from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
from atlaspatch_tpu_torch.models.sam2.hiera import MultiScaleAttention, trunk_attention_shapes
from atlaspatch_tpu_torch.ops import attention as A

# Hiera-tiny's 12 trunk blocks, in order, and the body each launches in bfloat16.
BF16_BLOCKS = [
    ("stage-0 window 64/64", "wgmma_m64"),
    ("q-pool 16/64", "mma"),
    ("stage-1 window 16/16", "mma"),
    ("q-pool 4/16", "mma"),
    ("stage-2 window 196/196", "wgmma_m128"),
    ("global 2304", "wgmma_m192"),
    ("stage-2 window 196/196", "wgmma_m128"),
    ("global 2304", "wgmma_m192"),
    ("stage-2 window 196/196", "wgmma_m128"),
    ("global 2304", "wgmma_m192"),
    ("q-pool 49/196", "wgmma_m64"),
    ("stage-3 window 49/49", "wgmma_m64"),
]


@pytest.mark.parametrize("block", range(12), ids=[f"{i}-{b[0]}" for i, b in enumerate(BF16_BLOCKS)])
def test_fast_preset_blocks_get_their_variant(block):
    """bfloat16 at input 768, batch 8: the global blocks, the stage-0, stage-2
    and stage-3 windows and the 49/196 q-pool take the wgmma body."""
    n, h, tq, tk, d = trunk_attention_shapes(SAM2Config.tiny(), 768, 8)[block]
    assert A.kernel_variant(torch.bfloat16, tq, tk, d) == BF16_BLOCKS[block][1]


# The float32 default's 12 blocks: T_q > 16 on the 3xTF32 body, the q-pool and
# stage-1 blocks (T_q = 16 and 4, T_kv = 64 and 16) on the small-window body.
F32_BLOCKS = ["tf32x3", "f32_win", "f32_win", "f32_win"] + ["tf32x3"] * 8


@pytest.mark.parametrize("block", range(12))
def test_float32_default_blocks_take_the_float32_body(block):
    n, h, tq, tk, d = trunk_attention_shapes(SAM2Config.tiny(), 1024, 1)[block]
    assert A.kernel_variant(torch.float32, tq, tk, d) == F32_BLOCKS[block]


def test_float32_default_launches_per_forward():
    shapes = trunk_attention_shapes(SAM2Config.tiny(), 1024, 1)
    variants = [A.kernel_variant(torch.float32, tq, tk, d) for _, _, tq, tk, d in shapes]
    assert variants.count("tf32x3") == 9 and variants.count("f32_win") == 3
    assert "f32" not in variants
    assert [v for (n, h, tq, tk, d), v in zip(shapes, variants) if tq == 4096] == ["tf32x3"] * 3


def test_fast_preset_wgmma_launches_per_forward():
    shapes = trunk_attention_shapes(SAM2Config.tiny(), 768, 8)
    variants = [A.kernel_variant(torch.bfloat16, tq, tk, d) for _, _, tq, tk, d in shapes]
    globals_ = [v for (n, h, tq, tk, d), v in zip(shapes, variants) if tq == 2304]
    assert globals_ == ["wgmma_m192"] * 3
    assert sum(v.startswith("wgmma") for v in variants) == 9


@pytest.mark.parametrize(
    "dtype,tq,d,want",
    [
        (torch.bfloat16, 16, 96, "mma"),
        (torch.bfloat16, 17, 96, "wgmma_m64"),
        (torch.bfloat16, 64, 96, "wgmma_m64"),
        (torch.bfloat16, 65, 96, "wgmma_m128"),
        (torch.bfloat16, 129, 96, "wgmma_m192"),
        (torch.bfloat16, 196, 96, "wgmma_m128"),
        (torch.bfloat16, 384, 96, "wgmma_m192"),
        (torch.bfloat16, 2304, 64, "wgmma_m192"),
        (torch.bfloat16, 2304, 128, "wgmma_m128"),
        (torch.bfloat16, 2304, 80, "mma"),
        (torch.bfloat16, 300, 40, "mma"),
        (torch.float32, 2304, 96, "tf32x3"),
        (torch.float32, 4, 96, "f32"),
        (torch.float32, 16, 96, "f32"),
        (torch.float32, 17, 96, "tf32x3"),
        (torch.float32, 16, 64, "f32"),
        (torch.float32, 17, 64, "tf32x3"),
        (torch.float32, 2304, 128, "f32"),  # the tf32x3 body spills at D = 128
        (torch.float32, 2304, 80, "f32"),
        (torch.float32, 300, 40, "f32"),
    ],
)
def test_variant_edges(dtype, tq, d, want):
    assert A.kernel_variant(dtype, tq, 196, d) == want


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_only_float32_takes_the_tf32x3_body(d):
    for tq in (1, 4, 16, 17, 49, 64, 65, 196, 2304, 4096):
        assert A.kernel_variant(torch.bfloat16, tq, tq, d) != "tf32x3"
        if d in A.TF32X3_HEAD_DIMS and tq > 16:
            want = "tf32x3"
        else:
            want = "f32_win" if tq <= A.F32WIN_MAX_T else "f32"
        assert A.kernel_variant(torch.float32, tq, tq, d) == want


@pytest.mark.parametrize(
    "tq,tk,d,want",
    [
        (64, 64, 96, "tf32x3"),  # stage-0 window
        (65, 64, 96, "tf32x3"),
        (64, 65, 96, "tf32x3"),
        (17, 64, 96, "tf32x3"),
        (16, 64, 96, "f32_win"),  # q-pool 16/64
        (16, 65, 96, "f32"),
        (16, 16, 96, "f32_win"),  # stage-1 window
        (4, 16, 96, "f32_win"),  # q-pool 4/16
        (49, 49, 96, "tf32x3"),  # stage-3 window
        (49, 196, 96, "tf32x3"),  # q-pool 49/196
        (16, 64, 64, "f32_win"),
        (17, 17, 64, "tf32x3"),
        (1, 1, 96, "f32_win"),
        (64, 64, 128, "f32_win"),
        (65, 65, 128, "f32"),
        (64, 64, 40, "f32_win"),
        (64, 65, 40, "f32"),
        (64, 64, 8, "f32_win"),
    ],
)
def test_f32win_edges(tq, tk, d, want):
    """float32 takes the small-window body up to 64 query and 64 key rows
    where the 3xTF32 body (D 64 or 96, T_q > 16) does not."""
    assert A.kernel_variant(torch.float32, tq, tk, d) == want


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_bf16_never_takes_the_f32win_body(d):
    for tq in (1, 4, 16, 17, 49, 64, 65, 196):
        for tk in (1, 16, 49, 64, 65, 196):
            assert A.kernel_variant(torch.bfloat16, tq, tk, d) != "f32_win"


def _bf16_body(q, k, v, scale, p_dtype=torch.bfloat16, skip=0):
    """A bfloat16 body emulated in float64: P rounded to ``p_dtype`` before
    the PV product, the output to bfloat16. ``p_dtype`` other than bfloat16,
    or ``skip`` > 0 (keys [0, skip) dropped), plants a fault."""
    q, k, v = q.double(), k[:, :, skip:].double(), v[:, :, skip:].double()
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) * scale, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.float().to(p_dtype).double(), v)
    return out.to(torch.bfloat16).float()


def _limit_ratio(shape, scale_sign=1, **fault):
    """max |body - plain| / bf16_error_limit over the output, seeded inputs."""
    b, h, tq, tk, d = shape
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d), np.float32)).to(torch.bfloat16)
               for t in (tq, tk, tk))
    scale = scale_sign * d**-0.5
    want, limit = A.bf16_error_limit(q, k, v, scale)
    return ((_bf16_body(q, k, v, scale, **fault) - want).abs() / limit).max().item()


# (B, H, T_q, T_kv, D): a global block's rows at small B*H and Q length, the
# 49/196 q-pool, the stage-1 window, and D = 128.
LIMIT_SHAPES = [(1, 2, 256, 2304, 96), (2, 2, 49, 196, 96), (2, 4, 16, 16, 96), (1, 1, 128, 128, 128)]


@pytest.mark.parametrize("scale_sign", [1, -1])
@pytest.mark.parametrize("shape", LIMIT_SHAPES)
def test_bf16_limit_holds_a_sound_body(shape, scale_sign):
    """A body that rounds only where the bodies round stays within the limit
    (at most 0.57 of it at these shapes)."""
    assert _limit_ratio(shape, scale_sign) <= 0.75


@pytest.mark.parametrize(
    "shape,fault",
    [(s, "p_fp8") for s in LIMIT_SHAPES] + [(s, "tile_skipped") for s in LIMIT_SHAPES if s[3] > 64],
)
def test_bf16_limit_catches_planted_faults(shape, fault):
    """P in fp8 (e4m3) or one 64-key K/V tile skipped exceeds the limit
    several times over (6.8x at least at these shapes)."""
    kw = {"p_dtype": torch.float8_e4m3fn} if fault == "p_fp8" else {"skip": 64}
    assert _limit_ratio(shape, **kw) > 3.0


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by bit mask: the tf32x3 body's rounding."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(eq, a, b, passes):
    """einsum of float32 a and b in float64 as the body's mma computes it:
    each operand split into TF32 big + small, and small*big + big*small +
    big*big (passes=3); or big*big of operands rounded once (passes=1)."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    prod = lambda x, y: torch.einsum(eq, x.double(), y.double())  # noqa: E731
    if passes == 1:
        return prod(a_big, b_big)
    return prod(a_small, b_big) + prod(a_big, b_small) + prod(a_big, b_big)


def _tf32x3_body(q, k, v, scale, passes=3):
    """The tf32x3 body emulated in float64: q times scale * log2(e) in
    float32, scores in log2 units, P in float32, both products as
    ``_tf32_product`` takes them. ``passes=1`` plants a fault: one TF32 pass
    with no compensation (operands and P rounded to TF32 once)."""
    s = _tf32_product("bhqd,bhkd->bhqk", q * torch.tensor(scale * math.log2(math.e)), k, passes)
    p = torch.exp2(s - s.amax(-1, keepdim=True)).float()
    return (_tf32_product("bhqk,bhkd->bhqd", p, v, passes) / p.double().sum(-1, keepdim=True)).float()


def _f32_inputs(shape, scale_sign):
    b, h, tq, tk, d = shape
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d), np.float32)) for t in (tq, tk, tk))
    return q, k, v, scale_sign * d**-0.5


def _f32_limit_ratio(shape, scale_sign=1, passes=3):
    """max |body - plain| / f32_error_limit over the output, seeded inputs."""
    q, k, v, scale = _f32_inputs(shape, scale_sign)
    want, limit = A.f32_error_limit(q, k, v, scale)
    return ((_tf32x3_body(q, k, v, scale, passes) - want).abs() / limit).max().item()


# (B, H, T_q, T_kv, D): a global block's rows at small B*H and Q length, the
# 49/196 q-pool, a ragged D = 64 case, and a stage-2 window's Q tiles.
F32_LIMIT_SHAPES = [(1, 2, 256, 2304, 96), (2, 2, 49, 196, 96), (2, 2, 17, 300, 64), (1, 2, 100, 196, 96)]


@pytest.mark.parametrize("scale_sign", [1, -1])
@pytest.mark.parametrize("shape", F32_LIMIT_SHAPES)
def test_f32_limit_holds_a_sound_tf32x3_body(shape, scale_sign):
    """The 3xTF32 body stays far inside the limit (at most 0.072 of it at
    these shapes; the card reads up to 0.16, its sums truncated)."""
    assert _f32_limit_ratio(shape, scale_sign) <= 0.15


@pytest.mark.parametrize("scale_sign", [1, -1])
@pytest.mark.parametrize("shape", F32_LIMIT_SHAPES)
def test_f32_limit_catches_a_single_tf32_pass(shape, scale_sign):
    """One TF32 pass with no compensation exceeds the limit (12x at least at
    these shapes), where the flat 1e-4 may not tell it from a sound body."""
    assert _f32_limit_ratio(shape, scale_sign, passes=1) > 6.0


@pytest.mark.parametrize("shape", F32_LIMIT_SHAPES[1:])
def test_tf32x3_body_within_the_limit_of_the_jax_reference(shape):
    """The emulated 3xTF32 body against the JAX package's reference_attention
    (float32 on the CPU) on the same numpy inputs, at the float32 bars."""
    import jax.numpy as jnp

    from atlaspatch_tpu.ops.attention import reference_attention as jax_reference

    q, k, v, scale = _f32_inputs(shape, 1)
    want = torch.from_numpy(np.array(jax_reference(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                                     sm_scale=scale)))
    got = _tf32x3_body(q, k, v, scale)
    _, limit = A.f32_error_limit(q, k, v, scale)
    assert (got - want).abs().max().item() <= 1e-4
    assert ((got - want).abs() / limit).max().item() <= 0.15


def _f32win_body(q, k, v, scale):
    """The small-window body's arithmetic in float32: scores summed over D,
    times scale * log2(e) (one float32 product, as the launch folds it), the
    keys' max, exp2, the row sum, P V, and one division at the end."""
    fold = torch.tensor(scale, dtype=torch.float32) * torch.tensor(math.log2(math.e), dtype=torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * fold
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    return torch.einsum("bhqk,bhkd->bhqd", p, v) / p.sum(-1, keepdim=True)


# (B, H, T_q, T_kv, D): the float32 default's five window shapes at B*H <= 8:
# stage-0, the 16/64 q-pool, stage-1, the 4/16 q-pool, stage-3.
F32WIN_SHAPES = [(2, 1, 64, 64, 96), (2, 2, 16, 64, 96), (2, 2, 16, 16, 96), (2, 4, 4, 16, 96),
                 (2, 4, 49, 49, 96)]


@pytest.mark.parametrize("scale_sign", [1, -1])
@pytest.mark.parametrize("shape", F32WIN_SHAPES)
def test_f32win_body_within_the_limit_of_the_jax_reference(shape, scale_sign):
    """The small-window body emulated in float32 against the JAX package's
    reference_attention (float32 on the CPU) on the same numpy inputs:
    max-abs 1e-4 and at most 0.15 of f32_error_limit."""
    import jax.numpy as jnp

    from atlaspatch_tpu.ops.attention import reference_attention as jax_reference

    q, k, v, scale = _f32_inputs(shape, scale_sign)
    want = torch.from_numpy(np.array(jax_reference(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                                     sm_scale=scale)))
    got = _f32win_body(q, k, v, scale)
    _, limit = A.f32_error_limit(q, k, v, scale)
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-4
    assert ((got - want).abs() / limit).max().item() <= 0.15


def _trunk_views(dim, dim_out, heads, query_stride, monkeypatch):
    """The (q, k, v) that MultiScaleAttention.forward hands to attention()."""
    seen = []

    def capture(q, k, v, sm_scale=None):
        seen.append((q, k, v))
        return A.reference_attention(q, k, v, sm_scale)

    monkeypatch.setattr(hiera, "attention", capture)
    torch.manual_seed(0)
    msa = MultiScaleAttention(dim, dim_out, heads, query_stride)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, 8, dim), np.float32))
    with torch.no_grad():
        msa(x)
    (views,) = seen
    return views


TRUNK_ATTENTIONS = [
    (96, 96, 1, None),  # stage-0 window, Hiera-tiny's widths
    (96, 192, 2, 2),  # q-pool into stage 1
    (192, 192, 2, None),
    (384, 768, 8, 2),  # q-pool into stage 3
]


@pytest.mark.parametrize("dim,dim_out,heads,query_stride", TRUNK_ATTENTIONS)
def test_trunk_views_are_read_in_place(dim, dim_out, heads, query_stride, monkeypatch):
    """No copy before the kernel: D contiguous, 16-byte rows and bases."""
    for t in _trunk_views(dim, dim_out, heads, query_stride, monkeypatch):
        assert t.shape[-1] == 96
        assert A._kernel_readable(t) is t


@pytest.mark.parametrize("dim,dim_out,heads,query_stride", TRUNK_ATTENTIONS)
def test_trunk_views_make_valid_tensor_maps(dim, dim_out, heads, query_stride, monkeypatch):
    """A TMA map takes 16-byte-aligned bases and strides that are non-zero
    multiples of 16 bytes below 2^40; D is a multiple of the 32-column panel."""
    for t in _trunk_views(dim, dim_out, heads, query_stride, monkeypatch):
        assert t.data_ptr() % 16 == 0 and t.stride(3) == 1 and t.shape[-1] % 32 == 0
        for s in A._tma_strides(t):
            assert s > 0 and (2 * s) % 16 == 0 and 2 * s < 2**40


def test_tma_strides_of_unit_dims_are_contiguous():
    """Dimensions of size 1 carry whatever stride torch keeps; the map gets the
    contiguous one instead (it is never stepped)."""
    t = torch.zeros(30000).as_strided((1, 5, 1, 96), (3, 7 * 96 * 8, 1, 1))
    assert A._tma_strides(t) == [5 * 7 * 96 * 8, 7 * 96 * 8, 96]
    u = torch.zeros(30000).as_strided((3, 1, 49, 64), (49 * 192, 5, 192, 1))
    assert A._tma_strides(u) == [49 * 192, 49 * 192, 192]
    assert A._strides(u) == [49 * 192, 0, 192]


@pytest.mark.parametrize(
    "make",
    [
        lambda: torch.zeros(2, 3, 1, 96).expand(2, 3, 49, 96),  # one key row broadcast over T
        lambda: torch.zeros(2, 1, 49, 96).expand(2, 4, 49, 96),  # one head broadcast over H
        lambda: torch.zeros(2, 3, 49, 97)[..., 1:],  # rows off 16 bytes
        lambda: torch.zeros(2, 3, 96, 49).transpose(2, 3),  # D not contiguous
    ],
    ids=["broadcast_t", "broadcast_h", "misaligned", "d_strided"],
)
def test_views_no_body_can_read_are_copied(make):
    """After _kernel_readable every operand makes a valid tensor map."""
    t = make()
    got = A._kernel_readable(t)
    assert got is not t and got.is_contiguous()
    torch.testing.assert_close(got, t, rtol=0, atol=0)
    assert all(s > 0 and s % 8 == 0 for s in A._tma_strides(got))
