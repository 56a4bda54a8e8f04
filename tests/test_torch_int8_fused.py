"""The int8 quantizer fused with the op before it (``layernorm_quantize_rows``,
``act_quantize_rows``, ``quantize_heads``) and the quantizer's routing, on
the CPU: each plain version equals the unfused chain bit for bit in float32
and bfloat16, and, in float32, ``nn.LayerNorm`` / the MLP's ``_act``
followed by ``Int8Dense``'s quantizer within FUSED_FLIP_SHARE flipped xq
elements of at most 1 and scales within 2^-8; the int8 ViT through the
fused path equals the unfused chain bit for bit on the CPU; a gated MLP
quantizes its input once; the refusals; ``quant_variant`` by mode,
prologue and alignment. The rest of the int8 mode is in
``tests/test_torch_int8.py`` and ``tests/test_torch_int8_vit.py``.
"""

import re
from pathlib import Path

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlaspatch_tpu.models.encoders import vit as jvit
from atlaspatch_tpu_torch.models.encoders import vit as pvit
from atlaspatch_tpu_torch.models.encoders import zoo
from atlaspatch_tpu_torch.ops import int8 as I
from torch_int8_helpers import (ACTS, FUSED_FLIP_SHARE, FUSED_SPECS, TINY, _images, _int8_model, _int8_widths,
                                _params, _rows)


# --- the quantizer fused with the op before it -------------------------------------------
def _assert_fused_bar(got, want, what):
    """xq within 1 in at most FUSED_FLIP_SHARE of the elements, s_x within 2^-8."""
    (xq, s_x), (want_xq, want_s) = got, want
    diff = (xq.int() - want_xq.int()).abs()
    share = (diff > 0).float().mean().item()
    rel = ((s_x - want_s).abs() / want_s).max().item()
    print(f"{what}: {int((diff > 0).sum())} of {diff.numel()} xq flipped ({share:.2e}), s_x rel {rel:.2e}")
    assert diff.max().item() <= 1 and share <= FUSED_FLIP_SHARE and rel <= 2.0**-8, what


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [48, 64, 1024])
def test_layernorm_plain_version_is_the_unfused_chain(dtype, k):
    x = _rows(37, k, dtype, seed=k)
    norm = torch.nn.LayerNorm(k, eps=1e-6).to(dtype)
    with torch.no_grad():
        norm.weight.copy_(_rows(1, k, dtype, seed=1, scale=0.5)[0] + 1)
        norm.bias.copy_(_rows(1, k, dtype, seed=2, scale=0.5)[0])
        want = I.quantize_rows_plain(norm(x))
    for got in (I.layernorm_quantize_rows_plain(x, norm.weight, norm.bias, norm.eps),
                I.layernorm_quantize_rows(x, norm.weight, norm.bias, norm.eps)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate", [None, "swiglu", "gated"])
@pytest.mark.parametrize("act", ACTS)
def test_act_plain_version_is_the_unfused_chain(act, gate, dtype):
    """What Mlp.forward ran before the fusion: act(fc1(x)), act(x1) * x2 of
    one fc1 output's halves, act(fc_gate(x)) * fc_up(x)."""
    fn = pvit._act(act)
    h = _rows(37, 2 * 72 if gate == "swiglu" else 72, dtype, seed=5)
    if gate == "swiglu":
        a, b = h.chunk(2, dim=-1)
    else:
        a, b = h, (_rows(37, 72, dtype, seed=6) if gate == "gated" else None)
    want = I.quantize_rows_plain(fn(a) if b is None else fn(a) * b)
    for got in (I.act_quantize_rows_plain(a, act, b), I.act_quantize_rows(a, act, b)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_quantize_heads_is_the_reshaped_rows():
    """The attention's output as its einsum leaves it: (B, T, H, D), not
    contiguous, quantized as the (B T, H D) rows of its reshape."""
    attn = torch.softmax(_rows(2 * 4 * 5, 5, torch.float32, seed=7).reshape(2, 4, 5, 5), dim=-1)
    v = _rows(2 * 5 * 4, 8, torch.float32, seed=8).reshape(2, 5, 4, 8)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    assert not out.is_contiguous()
    want = I.quantize_rows_plain(out.reshape(10, 32))
    got = I.quantize_heads(out)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [48, 1024])
def test_layernorm_quantizer_matches_jax_layernorm_and_int8_dense(k):
    """float32 rows from numpy: the plain version against the JAX
    ``nn.LayerNorm`` followed by ``Int8Dense``'s quantizer."""
    rng = np.random.default_rng(k)
    x = rng.normal(0.3, 2.0, (64, k)).astype(np.float32)
    scale, bias = (1 + rng.normal(0, 0.5, k)).astype(np.float32), rng.normal(0, 0.5, k).astype(np.float32)
    y = fnn.LayerNorm(epsilon=1e-6).apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    want = jvit._q8_dyn(y, axis=-1)
    got = I.layernorm_quantize_rows_plain(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 1e-6)
    _assert_fused_bar(got, (torch.from_numpy(np.asarray(want[0])), torch.from_numpy(np.asarray(want[1])[:, 0])),
                      f"layernorm K={k}")


@pytest.mark.parametrize("gate", [None, "swiglu", "gated"])
@pytest.mark.parametrize("act", ACTS)
def test_act_quantizer_matches_jax_mlp_and_int8_dense(act, gate):
    """float32 rows from numpy: the plain version against the JAX MLP's
    ``_act`` (then ``* b``) followed by ``Int8Dense``'s quantizer."""
    rng = np.random.default_rng(3)
    a = rng.normal(0.0, 2.0, (64, 96)).astype(np.float32)
    b = rng.normal(0.0, 2.0, (64, 96)).astype(np.float32) if gate else None
    h = jvit._act(act)(jnp.asarray(a))
    want = jvit._q8_dyn(h if b is None else h * jnp.asarray(b), axis=-1)
    if gate == "swiglu":  # the two halves of one fc1 output
        both = torch.from_numpy(np.concatenate([a, b], axis=1))
        ta, tb = both.chunk(2, dim=-1)
    else:
        ta, tb = torch.from_numpy(a), None if b is None else torch.from_numpy(b)
    got = I.act_quantize_rows_plain(ta, act, tb)
    _assert_fused_bar(got, (torch.from_numpy(np.asarray(want[0])), torch.from_numpy(np.asarray(want[1])[:, 0])),
                      f"{act} {gate}")


def _unfused_forward(model: pvit.ViT, x: torch.Tensor) -> torch.Tensor:
    """The int8 ViT as the port ran it before the fusion: each LayerNorm and
    activation stored, the attention's output reshaped, every Int8Linear fed
    a plain tensor."""
    s = model.spec

    def block(blk, x):
        h = blk.norm1(x)
        B, T, _ = h.shape
        q, k, v = blk.attn.qkv(h).reshape(B, T, 3, s.heads, s.dim // s.heads).unbind(2)
        if s.pos_mode == "rope":
            cos = blk.attn.rope_cos.to(q.dtype)[None, :, None, :]
            sin = blk.attn.rope_sin.to(q.dtype)[None, :, None, :]
            n = T - cos.shape[1]
            qp, kp = q[:, n:], k[:, n:]
            q = torch.cat([q[:, :n], qp * cos + pvit._rotate_half(qp) * sin], dim=1)
            k = torch.cat([k[:, :n], kp * cos + pvit._rotate_half(kp) * sin], dim=1)
        out = pvit._softmax_attention(q, k, v, "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd")
        h = blk.attn.proj(out.reshape(B, T, s.dim))
        x = x + (h if blk.ls1 is None else h * blk.ls1)
        h, mlp = blk.norm2(x), blk.mlp
        if s.gated_mlp:
            h = mlp.act(mlp.fc_gate(h)) * mlp.fc_up(h)
        elif s.swiglu:
            x1, x2 = mlp.fc1(h).chunk(2, dim=-1)
            h = mlp.act(x1) * x2
        else:
            h = mlp.act(mlp.fc1(h))
        h = mlp.fc2(h)
        return x + (h if blk.ls2 is None else h * blk.ls2)

    blocks = model.blocks
    features = {}
    hook = blocks[0].register_forward_pre_hook(lambda mod, args: features.setdefault("in", args[0]))
    model(x)
    hook.remove()
    y = features["in"]
    for blk in blocks:
        y = block(blk, y)
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FUSED_SPECS))
def test_fused_blocks_equal_the_unfused_chain_on_the_cpu(case, dtype):
    """On the CPU the fused quantizers run the ops the port ran before, so
    the int8 blocks' output is unchanged bit for bit."""
    kw = FUSED_SPECS[case]
    model = _int8_model(kw, jvit.quantize_vit_params(_params(kw, seed=9)))
    model.to(dtype)
    for mod in model.modules():
        if isinstance(mod, pvit.Int8Linear):
            mod.qscale.data = mod.qscale.data.float()
    x = torch.from_numpy(_images(seed=9)).to(dtype)
    outputs = []
    hook = model.blocks[-1].register_forward_hook(lambda mod, args, out: outputs.append(out))
    with torch.no_grad():
        model(x)
        want = _unfused_forward(model, x)
    hook.remove()
    assert outputs[0].dtype == dtype and torch.equal(outputs[0], want)


def _counting(monkeypatch, names):
    calls = {name: 0 for name in names}
    for name in names:
        fn = getattr(pvit, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(pvit, name, counted)
    return calls


@pytest.mark.parametrize("case", sorted(FUSED_SPECS))
def test_quantizers_per_block_by_prologue(case, monkeypatch):
    """Per block: two layernorm quantizers (norm1 → qkv; norm2 → fc1, or
    shared by fc_gate and fc_up), one activation quantizer (→ fc2), one of
    the attention's output (→ proj), and no quantize_rows of a plain
    tensor."""
    kw = FUSED_SPECS[case]
    model = _int8_model(kw, jvit.quantize_vit_params(_params(kw)))
    calls = _counting(monkeypatch, ("layernorm_quantize_rows", "act_quantize_rows", "quantize_heads",
                                    "quantize_rows"))
    with torch.no_grad():
        model(torch.from_numpy(_images()))
    depth = TINY["depth"]
    assert calls == {"layernorm_quantize_rows": 2 * depth, "act_quantize_rows": depth, "quantize_heads": depth,
                     "quantize_rows": 0}


def test_prologue_codes_match_the_kernel_source():
    """ops/int8.py::PROLOGUES lists the C enum's prologues in its order."""
    src = (Path(I.__file__).parents[1] / "csrc" / "int8_linear.cu").read_text()
    enum = re.search(r"enum Prologue : int \{([^}]*)\}", src).group(1)
    assert [n.strip()[1:].lower() for n in enum.split(",")] == [n.replace("_", "") for n in I.PROLOGUES]


def test_fused_quantizers_refuse_what_they_do_not_take():
    x = torch.zeros(4, 8)
    w, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        I.layernorm_quantize_rows(x.half(), w.half(), b.half(), 1e-6)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        I.act_quantize_rows(x.half(), "gelu")
    with pytest.raises(ValueError, match="2-D"):
        I.act_quantize_rows(torch.zeros(2, 4, 8), "gelu")
    with pytest.raises(ValueError, match="4-D"):
        I.quantize_heads(x)
    with pytest.raises(ValueError, match="empty"):
        I.layernorm_quantize_rows(torch.zeros(0, 8), w, b, 1e-6)
    with pytest.raises(ValueError, match="empty"):
        I.act_quantize_rows(torch.zeros(0, 8), "silu")
    with pytest.raises(ValueError, match=r"\(8,\) torch.float32 weight"):
        I.layernorm_quantize_rows(x, torch.ones(7), b, 1e-6)
    with pytest.raises(ValueError, match=r"\(8,\) torch.float32 bias"):
        I.layernorm_quantize_rows(x, w, b.bfloat16(), 1e-6)
    with pytest.raises(ValueError, match=r"\(8,\) torch.float32 weight"):
        I.layernorm_quantize_rows(x, None, b, 1e-6)
    with pytest.raises(ValueError, match="no activation 'tanh'"):
        I.act_quantize_rows(x, "tanh")
    with pytest.raises(ValueError, match="takes b like a"):
        I.act_quantize_rows(x, "silu", torch.zeros(4, 9))
    with pytest.raises(ValueError, match="takes b like a"):
        I.act_quantize_rows(x, "silu", x.bfloat16())


@pytest.mark.parametrize("mode,prologue,run,elem,align,want", [
    ("one_pass", "identity", 1024, 2, 16, ("template", 0)), ("one_pass", "gelu_tanh", 4096, 4, 16, ("template", 0)),
    ("amax_only", "layernorm", 1024, 2, 16, ("template", 0)), ("given_amax", "layernorm", 1024, 2, 16, ("template", 0)),
    ("amax_only", "identity", 512, 2, 16, ("stream", 32)), ("given_amax", "identity", 512, 4, 16, ("stream", 32)),
    ("amax_only", "identity", 64, 2, 16, ("stream", 32)), ("given_amax", "identity", 72, 2, 16, ("stream", 16)),
    ("amax_only", "gelu_tanh", 2048, 2, 16, ("stream", 32)), ("given_amax", "identity", 4096, 2, 16, ("stream", 32)),
    ("given_amax", "identity", 1708, 2, 16, ("stream", 8)), ("amax_only", "silu", 1708, 4, 16, ("stream", 16)),
    ("given_amax", "identity", 2152, 2, 16, ("stream", 16)), ("amax_only", "identity", 95, 2, 16, ("stream", 2)),
    ("given_amax", "identity", 96, 2, 2, ("stream", 2)), ("given_amax", "identity", 96, 2, 8, ("stream", 8)),
    ("amax_only", "relu", 90, 4, 16, ("stream", 8)), ("amax_only", "quick_gelu", 45, 4, 16, ("stream", 4)),
    ("given_amax", "identity", 44, 4, 4, ("stream", 4)), ("given_amax", "silu", 4096, 2, 16, ("template", 0)),
    ("given_amax", "gelu_tanh", 1708, 2, 16, ("template", 0)), ("given_amax", "gelu", 44, 4, 4, ("template", 0)),
])
def test_quant_variant_by_mode_prologue_and_alignment(mode, prologue, run, elem, align, want):
    """The one-pass mode, layernorm and an activation's given-amax (the forward quantizes the
    activation's stored values by the identity prologue instead) stay on the template; amax-only of
    the identity and the activations and the identity's given-amax take the streamed body, in the
    widest unit of 32, 16 or 8 bytes that tiles the run of values (a row, or a head) and whose loads
    (at most 16 bytes) the operands' alignment admits, else in single elements."""
    assert I.quant_variant(mode, prologue, run, elem, align) == want


def test_operand_alignment_of_the_quantizers_views():
    """The largest power of two, at most 16, dividing the operands' bases and strides in bytes: a
    contiguous bfloat16 row of 2,048 and its (B, T, H, D) heads view; a SwiGLU half (row stride 3,416
    values); a view from an odd element; a gated pair whose second operand starts 4 or 1 floats in."""
    x = torch.zeros(8, 2048, dtype=torch.bfloat16)
    assert I._operand_alignment(x, (0, 2048, 8, 0, 2048)) == 16
    heads = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert I._operand_alignment(heads, (heads.stride(0), heads.stride(1), 4, heads.stride(2), 64)) == 16
    half = torch.zeros(8, 2 * 1708, dtype=torch.bfloat16)[:, 1708:]
    assert I._operand_alignment(half, (0, half.stride(0), 8, 0, 1708)) == 8
    odd = x[:, 1:]
    assert I._operand_alignment(odd, (0, odd.stride(0), 8, 0, 2047)) == 2
    a = torch.zeros(8, 64)
    assert I._operand_alignment(a, (0, 64, 8, 0, 64), torch.zeros(8, 68)[:, 4:]) == 16
    assert I._operand_alignment(a, (0, 64, 8, 0, 64), torch.zeros(8, 65)[:, 1:]) == 4


def test_quant_variant_refuses_unknown_names():
    with pytest.raises(ValueError, match="has modes"):
        I.quant_variant("two_pass", "identity", 64)
    with pytest.raises(ValueError, match="prologues"):
        I.quant_variant("amax_only", "tanh", 64)


@pytest.mark.parametrize("name", sorted(n for n, e in zoo.ENTRIES.items()
                                        if isinstance(getattr(e, "spec", None), pvit.ViTSpec)))
def test_quant_variant_at_the_zoo_tp_shards(name):
    """Every zoo ViT's TP (1, 2) shards in bfloat16 (the attention's heads before proj, whose units
    tile one head of D values; half the hidden units before fc2: the activation's amax-only, then
    given-amax over its stored rows by the identity prologue) take the streamed body in 32-byte
    units, but medsiglip's (D 72 and fc2 K 2,152: 16 bytes) and virchow's fc2 (K 1,708: 8)."""
    spec = zoo.ENTRIES[name].spec
    k_fc2 = _int8_widths(name)["fc2"][0] // 2
    want = {"medsiglip": 16, "virchow_v1": 8, "virchow_v2": 8}.get(name, 32)
    for mode in ("amax_only", "given_amax"):
        head = 16 if name == "medsiglip" else 32
        assert I.quant_variant(mode, "identity", spec.dim // spec.heads) == ("stream", head)
    assert I.quant_variant("amax_only", "gelu_tanh", k_fc2) == ("stream", want), k_fc2
    assert I.quant_variant("given_amax", "identity", k_fc2) == ("stream", want), k_fc2


@pytest.mark.parametrize("gate", [None, "gated"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stored_activation_quantized_by_identity_equals_the_act_quantizer(act, gate, dtype):
    """A shard's amax-only, which also returns the activation's values: its amax is their rows'
    abs-max, and those values quantized with a given amax by the identity prologue are
    act_quantize_rows's bytes and scales with it, bit for bit (the plain versions; the card test
    holds the kernels)."""
    a = _rows(64, 96, dtype, seed=12)
    b = _rows(64, 96, dtype, seed=13) if gate else None
    amax, values = I.act_row_amax(a, act, b)
    assert values.dtype == dtype and values.shape == (64, 96)
    assert torch.equal(amax, I.row_amax_plain(I._act_rows(a, act, b)))
    given = amax * 1.5  # the maxed amax of another shard
    got = I.quantize_rows(values, given)
    want = I.act_quantize_rows_plain(a, act, b, amax=given)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_rows_longer_than_the_registers_hold_are_refused_before_a_launch():
    """The kernel holds a row in registers (at most QUANT_MAX_K values): a
    longer one is refused before the library is touched."""
    I.reset_launch_counts()
    x = torch.zeros(2, I.QUANT_MAX_K + 16)
    with pytest.raises(ValueError, match=f"at most {I.QUANT_MAX_K} values"):
        I._launch_quantize("identity", x, (0, x.stride(0), 2, 0, x.shape[1]))
    assert I.quantize_rows.launches == 0 and not I.quantize_rows.prologue_launches
