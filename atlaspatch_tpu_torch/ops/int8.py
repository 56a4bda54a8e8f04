"""The int8 serving mode's linear: a row quantizer and an int8 tensor-core product.

The two halves of ``atlaspatch_tpu/models/encoders/vit.py::Int8Dense``
(:124-157), which XLA fuses into one program on the TPU:

- ``quantize_rows(x) -> (xq, s_x)``: symmetric dynamic abs-max int8 per row,
  the JAX ``_q8_dyn`` along the last axis (``vit.py:202-206``, inlined in
  ``Int8Dense`` at :143-145), and the same quantizer fused with the op before
  it, as XLA fuses them on the TPU: ``quantize_heads`` (the attention's
  (B, T, H, D) output, read where it lies), ``layernorm_quantize_rows``
  (``F.layer_norm`` then the quantizer: ``norm1`` → ``qkv``, ``norm2`` →
  ``fc1``) and ``act_quantize_rows`` (``act(a)`` or ``act(a) * b``, then the
  quantizer: the MLP's activation → ``fc2``);
- ``int8_linear(xq, s_x, weight_q, qscale, bias, out_dtype)``: ``xq @
  weight_q^T`` in int32, then ``float32(acc) * (s_x * qscale)``, then ``+
  bias``, then the cast to ``out_dtype`` (``vit.py:146-156``, in that order).

Tensor-parallel int8 splits a row-parallel linear's K over shards, and the
JAX program still computes one device's result: the row's abs-max is taken
across the shards and the int32 partials are summed before the one
dequantization. Its halves here: ``row_amax``, ``heads_amax`` and
``act_row_amax`` (the quantizer's prologue and reduction: a shard's (M,)
abs-max of its slice of the rows); the quantizers' ``amax=`` (the row's
scale from the abs-max given, max over the shards, instead of the rows
read); ``int8_linear_s32`` (the int32 product, no dequantization); and
``dequant_sum`` (the shards' int32 partials summed, then ``int8_linear``'s
epilogue), each with its plain version (``row_amax_plain``,
``int8_linear_s32_plain``, ``dequant_sum_plain``; the quantizers' plain
versions take ``amax`` too). The two tensor-parallel modes run on streamed
bodies of their own (``quant_variant``); ``act_row_amax`` also returns the
activation's values, for ``quantize_rows(values, amax)`` to quantize, so
that the activation is computed once.

Each dispatches on the tensor's device: a CPU tensor runs the plain PyTorch
version beside it (``quantize_rows_plain``, ``layernorm_quantize_rows_plain``,
``act_quantize_rows_plain``, ``int8_linear_plain``: the unfused chain the
port ran before the quantizer took the ops in), a CUDA tensor launches a
kernel of the ``atlas_int8_linear`` library (nvcc, sm_90a, built at first use
and loaded with ctypes): ``quantize_rows_s8`` of ``csrc/int8_linear.cu`` with
the prologue of ``PROLOGUES`` the call names (``identity`` equal to the plain
version bit for bit, ``layernorm`` and the activations where their float
arithmetic equals ATen's) in one of ``QUANT_MODES``, on the body
``quant_variant`` picks (``template``, the one-pass kernel, or ``stream``,
the tensor-parallel modes' warp-per-row amax-only and, for the identity
prologue, elementwise given-amax bodies), one of
``int8_linear_s8``'s two bodies (equal bit for bit), picked by
``linear_variant``: ``wgmma`` (``csrc/int8_linear_wgmma.cu``, wgmma s8 fed by
TMA; bfloat16 out, and the int32 output of ``int8_linear_s32``) or ``mma``
(``csrc/int8_linear.cu``, mma.sync fed by cp.async: float32 out, row pitches
no multiple of 16 bytes, misaligned bases, and N its TMA store cannot take),
and ``dequant_sum_s32`` (``csrc/int8_linear.cu``). The 16-byte row pitch:
on the card the quantizers write ``xq`` into an (M, ``pitch16(K)``) buffer
and return its (M, K) view, and ``pitched`` gives an int8 weight the same
pitch (the ViT does it once, where its weights reach the card:
``models/encoders/vit.py::pitch_int8_weights``), so that a product whose K is
no multiple of 16 (virchow's fc2, K 3,416; the TP shards of K 1,708 and
2,152) runs on the wgmma body; the pad bytes are never read. A build, tensor-map encode or
launch failure on a CUDA tensor raises: nothing retries on the other body or
falls back to the plain version or to ``torch._int_mm``.
``quantize_rows.launches``, ``int8_linear.launches`` and
``dequant_sum.launches`` count kernel launches,
``quantize_rows.prologue_launches``, ``.mode_launches`` and
``.body_launches`` the first by prologue, by mode and by body,
``int8_linear.variant_launches`` and
``.out_launches`` the second by body and by output dtype (``bfloat16``,
``float32``, ``int32``); ``reset_launch_counts()`` zeroes them all.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from collections import Counter

import torch
import torch.nn.functional as F

from atlaspatch_tpu_torch.build import CSRC, build_shared_library, nvcc_path

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FLOATS = (torch.float32, torch.bfloat16)
_LIB: list[ctypes.CDLL] = []
_LOCK = threading.Lock()
# The wgmma body's return codes beyond a cudaError (csrc/int8_linear_wgmma.cu).
_ENCODE_FAILED, _NO_DRIVER_ENTRY = 1_000_000, 2_000_000
LINEAR_VARIANTS = ("wgmma", "mma")
WGMMA_BLOCK_NS = (128, 256)  # the wgmma body's CTA tile widths (its two instantiations a dtype)
WGMMA_BLOCK_M = 128
# The activations by name, as the ViT's MLP runs them (models/encoders/vit.py::_act).
ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "silu": F.silu,
    "relu": F.relu,
}
# quantize_rows_s8's prologues and modes, in the order of csrc/int8_linear.cu's codes.
PROLOGUES = ("identity", "layernorm", *ACTIVATIONS)
QUANT_MODES = ("one_pass", "amax_only", "given_amax")
QUANT_BODIES = ("template", "stream")
# int8_linear_s8's output types, by the C entries' codes (the wgmma body writes bfloat16 and int32)
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
MAX_PARTIALS = 8  # dequant_sum_s32's most partials (kMaxPartials)
QUANT_MAX_K = 8192  # the longest row quantize_rows_s8 holds in registers (256 threads x 32 values)


def load_int8_library() -> ctypes.CDLL:
    """Build (once) and load ``csrc/int8_linear.cu`` and
    ``csrc/int8_linear_wgmma.cu`` as one library; raises if the build fails."""
    if _LIB:
        return _LIB[0]
    with _LOCK:
        if not _LIB:
            path = build_shared_library(
                "atlas_int8_linear", [CSRC / "int8_linear.cu", CSRC / "int8_linear_wgmma.cu"],
                [nvcc_path(), *_NVCC_FLAGS])
            lib = ctypes.CDLL(str(path))
            lib.atlas_quantize_rows_s8.restype = _INT
            lib.atlas_quantize_rows_s8.argtypes = [_INT] * 4 + [_PTR, _LL, _LL, _INT, _LL, _INT, _PTR, _LL, _PTR,
                                                                _PTR, ctypes.c_float, _PTR, _LL] + [_PTR] * 3 + [
                                                                    _INT, _PTR, _PTR]
            lib.atlas_quantize_rows_s8_stream.restype = _INT
            lib.atlas_quantize_rows_s8_stream.argtypes = [_INT] * 4 + [_PTR, _LL, _LL, _INT, _LL, _INT, _PTR, _LL,
                                                                       _INT, _PTR, _LL, _PTR, _INT, _PTR, _PTR, _PTR]
            lib.atlas_int8_linear_s8.restype = _INT
            lib.atlas_int8_linear_s8.argtypes = [_PTR] * 5 + [_INT, _PTR] + [_INT] * 4 + [_LL, _LL, _PTR]
            lib.atlas_dequant_sum_s32.restype = _INT
            lib.atlas_dequant_sum_s32.argtypes = [_PTR, _INT, _PTR, _PTR, _PTR, _INT, _PTR, _INT, _INT, _INT, _PTR]
            lib.atlas_int8_linear_s8_wgmma.restype = _INT
            lib.atlas_int8_linear_s8_wgmma.argtypes = [_PTR] * 5 + [_INT, _PTR] + [_INT] * 4 + [_LL, _LL] + [
                _INT] * 2 + [_PTR]
            _LIB.append(lib)
        return _LIB[0]


# the wgmma body's output rows: a multiple of 16 bytes (a TMA map's row stride), N a multiple of this
_WGMMA_N_MULTIPLE = {torch.bfloat16: 8, torch.int32: 4}


def pitch16(k: int) -> int:
    """The 16-byte row pitch of K int8 values: K rounded up to a multiple of 16."""
    return -(-k // 16) * 16


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def pitched(t: torch.Tensor, device: torch.device | str | None = None) -> torch.Tensor:
    """An int8 (rows, K) tensor on ``device`` (default: its own) whose rows lie
    ``pitch16(K)`` bytes apart from a 16-byte-aligned base: ``t`` itself
    where it already lies so, else an (rows, K) view of a new (rows,
    pitch16(K)) buffer holding its values. The pad bytes are left as they
    are: no kernel reads them."""
    device = t.device if device is None else resolve_device(device)
    rows, k = t.shape
    if t.device == device and t.stride(1) == 1 and (rows == 1 or t.stride(0) == pitch16(k)) \
            and t.data_ptr() % 16 == 0:
        return t
    out = torch.empty(rows, pitch16(k), dtype=t.dtype, device=device)[:, :k]
    return out.copy_(t)


def wgmma_admits(N: int, K: int, out_dtype: torch.dtype, xq_ptr: int = 0, w_ptr: int = 0,
                 ldx: int | None = None, ldw: int | None = None) -> bool:
    """Whether the wgmma body takes an (M, K) x (N, K) product to ``out_dtype``
    over operands at these addresses whose rows lie ``ldx`` and ``ldw``
    bytes apart (default K: contiguous). Its TMA maps want each row pitch
    and base on 16 bytes (K itself may be anything: the maps' K extent is K,
    and the last box is zero-filled past it), and its epilogue stores
    bfloat16 or int32 rows by TMA, whose stride must be a multiple of 16
    bytes too: N a multiple of 8 (bfloat16) or 4 (int32)."""
    multiple = _WGMMA_N_MULTIPLE.get(out_dtype)
    ldx, ldw = K if ldx is None else ldx, K if ldw is None else ldw
    return (multiple is not None and N % multiple == 0 and ldx >= K and ldw >= K and ldx % 16 == 0
            and ldw % 16 == 0 and xq_ptr % 16 == 0 and w_ptr % 16 == 0)


def linear_variant(M: int, N: int, K: int, out_dtype: torch.dtype, xq_ptr: int = 0, w_ptr: int = 0,
                   ldx: int | None = None, ldw: int | None = None) -> str:
    """The body ``int8_linear`` or ``int8_linear_s32`` launches for an (M, K)
    x (N, K) product to ``out_dtype`` whose operands start at these
    addresses with rows ``ldx`` and ``ldw`` bytes apart (default K):
    ``wgmma`` where ``wgmma_admits`` (every linear of the int8 engine, which
    runs bfloat16 with xq and the weights at a 16-byte pitch, and the int32
    partials of every zoo ViT's row-parallel shards under tensor-parallel
    int8: virchow's fc2, K = 3,416 = 16 x 213.5, and the shards of K 1,708
    and 2,152 too), else ``mma``: contiguous operands whose K is no
    multiple of 16, float32 output, N not a multiple of 8 (bfloat16) or 4
    (int32), bases or pitches off 16 bytes. M does not decide: at M = 5 the
    wgmma body is faster than the mma body too (both are bound by reading
    the weights; PERF.md), so small batches stay on it."""
    return "wgmma" if wgmma_admits(N, K, out_dtype, xq_ptr, w_ptr, ldx, ldw) else "mma"


def wgmma_block_n(M: int, N: int, sms: int = 132, out_dtype: torch.dtype = torch.bfloat16, K: int = 0) -> int:
    """The wgmma body's CTA tile width for an (M, N) ``out_dtype`` output on
    a card of ``sms`` SMs. bfloat16: 256, whose tiles read less from L2 per
    product, unless its tiles are fewer than the SMs, where 128 doubles the
    CTAs at work (at M = 5, medsiglip's MLP runs 1.7-1.9x faster so).
    Measured on an H100 (``tools/int8_variants.py``, PERF.md): at vit_l_16's
    batch-256 shapes 256 is level with 128 or up to 26% faster, but for qkv
    (2-4% slower); at batch 32 the two are within the run-to-run spread.
    int32 (K needed): 128, whose 64 KB tile leaves 5 ring stages, unless
    the 256-wide tiles give each SM 128 or more 128-byte K blocks to run (a
    256-wide int32 slice is staged in two halves through one 64 KB buffer,
    beside 3 stages: it reads Xq half as often, but waits between its halves
    and makes the last wave coarser, which only long products repay).
    Measured on an H100 (PERF.md), it picks the faster width at every TP
    (1, 2) shard of vit_l_16 and dinov3_vit7b16 at batch 32 and 256: 128 at
    vit_l_16's batch-32 shards, its batch-256 proj and the 7B's batch-32
    proj (by 2-13%), 256 at the 7B's batch-32 fc2 (9%) and the other
    batch-256 shards (2-24%)."""
    tiles = -(-M // WGMMA_BLOCK_M) * -(-N // 256)
    if out_dtype == torch.int32:
        return 256 if tiles * -(-K // 128) >= 128 * sms else 128
    return 256 if tiles >= sms else 128


def quant_variant(mode: str, prologue: str, run: int, elem: int = 2, align: int = 16) -> tuple[str, int]:
    """The body ``quantize_rows_s8`` runs a call on, and the streamed body's
    unit in bytes: ``("template", 0)`` for the one-pass mode, the layernorm
    prologue and an activation's given-amax (the template picks its own
    units; the forward's given-amax quantizes stored activation values by the
    identity prologue instead); else ``("stream", w)``, the tensor-parallel
    modes' own bodies, in units of w = 32, 16 or 8 bytes where w divides a
    ``run`` of values of ``elem`` bytes (the row of K values; a head's D in
    the attention's (B, T, H, D) layout) and its loads' width, min(w, 16),
    divides ``align`` (the largest power of two, at most 16, that divides
    every operand's base address and strides in bytes), else of one element
    (w = ``elem``). Wider units run faster on an H100 (PERF.md): every zoo
    ViT's TP (1, 2) shards in bfloat16 take 32 but medsiglip's (D 72, fc2 K
    2,152: 16) and virchow's fc2 (K 1,708: 8)."""
    if mode not in QUANT_MODES or prologue not in PROLOGUES:
        raise ValueError(f"quantize_rows_s8 has modes {QUANT_MODES} and prologues {PROLOGUES}, got {mode!r}, "
                         f"{prologue!r}")
    if mode == "one_pass" or prologue == "layernorm" or (mode == "given_amax" and prologue != "identity"):
        return "template", 0
    for width in (32, 16, 8):
        if align % min(width, 16) == 0 and run * elem % width == 0:
            return "stream", width
    return "stream", elem


def _operand_alignment(x, layout, b=None) -> int:
    """The largest power of two, at most 16, that divides a quantizer call's
    operands' offsets in bytes: x's base and its layout's strides, b's base
    and row stride."""
    sb, st, _, sh, _ = layout
    elem = x.element_size()
    offsets = [x.data_ptr(), sb * elem, st * elem, sh * elem]
    if b is not None:
        offsets += [b.data_ptr(), b.stride(0) * elem]
    align = 16
    for offset in offsets:
        while offset % align:
            align //= 2
    return align


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on every device. (A Python scalar divisor
    of a CUDA tensor becomes a multiply by its reciprocal, which rounds
    otherwise.)"""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def quantize_plain(x: torch.Tensor, dim: int, amax: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric dynamic abs-max int8 along ``dim`` of a float32 tensor, the
    JAX ``_q8_dyn``: (int8 values, float32 scales with ``dim`` kept). A given
    ``amax`` (``dim`` kept) takes the place of the abs-max of x."""
    if amax is None:
        amax = x.abs().amax(dim=dim, keepdim=True)
    s = _divide(amax.clamp_min(1e-8), 127.0)
    return torch.round(x / s).clamp(-127.0, 127.0).to(torch.int8), s


def int_product(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int32 result of ``torch.einsum(equation)`` over int8 operands,
    exact: an int32 product on the CPU; on the card, which has no int32
    product, a float64 one (every partial sum of int8 products is an integer
    far below 2^53) converted back."""
    if a.device.type == "cpu":
        return torch.einsum(equation, a.to(torch.int32), b.to(torch.int32))
    return torch.einsum(equation, a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def row_amax_plain(rows: torch.Tensor) -> torch.Tensor:
    """(M, K) float32 or bfloat16 rows (a prologue's output) → their (M,)
    float32 abs-max: what the quantizer reduces before s = max(amax, 1e-8) /
    127."""
    return rows.float().abs().amax(dim=-1)


def quantize_rows_plain(x: torch.Tensor, amax: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float32 or bfloat16 → (xq (M, K) int8, s_x (M,) float32); s_x
    from the given (M,) ``amax`` where there is one."""
    xq, s = quantize_plain(x.float(), -1, None if amax is None else amax[:, None])
    return xq, s[:, 0]


def layernorm_quantize_rows_plain(x, weight, bias, eps) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_rows_plain(F.layer_norm(x))`` over (M, K) rows: the
    ``nn.LayerNorm`` forward, stored in x's dtype, then the quantizer."""
    return quantize_rows_plain(F.layer_norm(x, (x.shape[-1],), weight, bias, eps))


def _plain_rows(x: torch.Tensor, amax: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_rows_plain(x)``, called as the one-pass quantizer always
    called it, or with the given ``amax``."""
    return quantize_rows_plain(x) if amax is None else quantize_rows_plain(x, amax)


def _act_rows(a, act: str, b=None) -> torch.Tensor:
    """``act(a)``, or ``act(a) * b`` (SwiGLU, the gated MLP), each op stored
    in a's dtype."""
    h = ACTIVATIONS[act](a)
    return h if b is None else h * b


def act_quantize_rows_plain(a, act: str, b=None, amax=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_rows_plain(act(a))``, or of ``act(a) * b`` (SwiGLU, the
    gated MLP), over (M, K) rows, each op stored in a's dtype."""
    return _plain_rows(_act_rows(a, act, b), amax)


def _dequantize(acc, s_x, qscale, bias, out_dtype) -> torch.Tensor:
    """The int32 (M, N) ``acc`` → float32(acc) * (s_x[m] * qscale[n]) +
    bias[n], cast to ``out_dtype``."""
    y = acc.float() * (s_x[:, None] * qscale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_linear_s32_plain(xq, weight_q) -> torch.Tensor:
    """(M, K) int8 · (N, K) int8 → the exact (M, N) int32 product."""
    return int_product("mk,nk->mn", xq, weight_q)


def int8_linear_plain(xq, s_x, weight_q, qscale, bias, out_dtype) -> torch.Tensor:
    """(M, K) int8 · (N, K) int8 → (M, N) ``out_dtype``, dequantized by
    float32(acc) * (s_x[m] * qscale[n]) + bias[n]."""
    return _dequantize(int8_linear_s32_plain(xq, weight_q), s_x, qscale, bias, out_dtype)


def dequant_sum_plain(partials, s_x, qscale, bias, out_dtype) -> torch.Tensor:
    """(M, N) int32 partials of one product whose K was split → their int32
    sum, dequantized as ``int8_linear_plain`` dequantizes."""
    acc = partials[0]
    for part in partials[1:]:
        acc = acc + part
    return _dequantize(acc, s_x, qscale, bias, out_dtype)


def _check_2d(name: str, t: torch.Tensor, dtype=None) -> None:
    if t.ndim != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def _stream(t: torch.Tensor) -> int:
    """The current stream of the card ``t`` lies on, as the C entries take it."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check_rows(name: str, x: torch.Tensor, ndim: int) -> None:
    if x.ndim != ndim:
        raise ValueError(f"{name} takes a {ndim}-D tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _FLOATS:
        raise ValueError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if not (x.is_cpu or x.is_cuda):
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {x.device}")


def _check_amax(name: str, amax: torch.Tensor | None, rows: int, x: torch.Tensor) -> None:
    if amax is not None and (amax.shape != (rows,) or amax.dtype != torch.float32 or amax.device != x.device):
        raise ValueError(f"{name} takes a ({rows},) torch.float32 amax on {x.device}, got "
                         f"{tuple(amax.shape)} {amax.dtype} on {amax.device}")


def _rows_layout(name: str, x: torch.Tensor):
    """A CUDA (M, K) operand → (x with unit column stride, its layout)."""
    if x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{name} got an empty input: {tuple(x.shape)}")
    if x.stride(1) != 1:
        x = x.contiguous()
    return x, (0, x.stride(0), x.shape[0], 0, x.shape[1])


def quantize_rows(x: torch.Tensor, amax: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float32 or bfloat16 → (xq (M, K) int8, s_x (M,) float32): the
    plain version on the CPU, ``quantize_rows_s8`` (``identity``) on the card,
    which reads rows of any stride where they lie. With ``amax`` (M,) float32,
    s_x comes from it (given-amax), not from the rows read."""
    _check_rows("quantize_rows", x, 2)
    _check_amax("quantize_rows", amax, x.shape[0], x)
    if x.is_cpu:
        return _plain_rows(x, amax)
    return _launch_quantize("identity", *_rows_layout("quantize_rows", x), amax=amax)


def row_amax(x: torch.Tensor) -> torch.Tensor:
    """(M, K) float32 or bfloat16 → the rows' (M,) float32 abs-max: the plain
    version on the CPU, ``quantize_rows_s8`` (``identity``, amax-only) on the
    card."""
    _check_rows("row_amax", x, 2)
    if x.is_cpu:
        return row_amax_plain(x)
    return _launch_quantize("identity", *_rows_layout("row_amax", x), mode="amax_only")


def _heads_layout(name: str, x: torch.Tensor):
    """A CUDA (B, T, H, D) operand → (x with unit stride along D, its layout,
    B T rows, H D columns)."""
    B, T, H, D = x.shape
    if x.numel() == 0:
        raise ValueError(f"{name} got an empty input: {tuple(x.shape)}")
    if x.stride(3) != 1:
        x = x.contiguous()
    return x, (x.stride(0), x.stride(1), T, x.stride(2), D), B * T, H * D


def quantize_heads(x: torch.Tensor, amax: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, H, D) float32 or bfloat16 → the quantized rows of its (B T, H D)
    reshape: (xq (B T, H D) int8, s_x (B T,) float32). The attention's output
    as its einsum leaves it, (B, H, T, D) in memory: the card reads it there,
    where a reshape would copy it first; the CPU runs the plain version on
    the reshape. With ``amax`` (B T,) float32, s_x comes from it."""
    _check_rows("quantize_heads", x, 4)
    B, T, H, D = x.shape
    _check_amax("quantize_heads", amax, B * T, x)
    if x.is_cpu:
        return _plain_rows(x.reshape(B * T, H * D), amax)
    x, layout, rows, cols = _heads_layout("quantize_heads", x)
    return _launch_quantize("identity", x, layout, rows=rows, cols=cols, amax=amax)


def heads_amax(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) float32 or bfloat16 → the (B T,) float32 abs-max of its
    (B T, H D) rows, read where they lie on the card (amax-only)."""
    _check_rows("heads_amax", x, 4)
    B, T, H, D = x.shape
    if x.is_cpu:
        return row_amax_plain(x.reshape(B * T, H * D))
    x, layout, rows, cols = _heads_layout("heads_amax", x)
    return _launch_quantize("identity", x, layout, rows=rows, cols=cols, mode="amax_only")


def layernorm_quantize_rows(x, weight, bias, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float32 or bfloat16 rows, their LayerNorm's (K,) ``weight`` and
    ``bias`` in x's dtype and ``eps`` → the quantized ``F.layer_norm(x)``:
    (xq (M, K) int8, s_x (M,) float32). The plain version on the CPU,
    ``quantize_rows_s8`` (``layernorm``) on the card, which never stores the
    normalized rows."""
    _check_rows("layernorm_quantize_rows", x, 2)
    M, K = x.shape
    card = x.get_device()
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None or t.shape != (K,) or t.dtype != x.dtype or t.get_device() != card:
            raise ValueError(f"layernorm_quantize_rows takes a ({K},) {x.dtype} {name} on {x.device}, got "
                             f"{None if t is None else (tuple(t.shape), t.dtype, str(t.device))}")
    if M == 0 or K == 0:
        raise ValueError(f"layernorm_quantize_rows got an empty input: {tuple(x.shape)}")
    if x.is_cpu:
        return layernorm_quantize_rows_plain(x, weight, bias, eps)
    if x.stride(1) != 1:
        x = x.contiguous()
    return _launch_quantize("layernorm", x, (0, x.stride(0), M, 0, K), gamma=weight.contiguous(),
                            beta=bias.contiguous(), eps=eps)


def _check_act(name: str, a: torch.Tensor, act: str, b: torch.Tensor | None):
    """The activation prologue's operands, checked; on the card with unit
    column strides."""
    _check_rows(name, a, 2)
    if act not in ACTIVATIONS:
        raise ValueError(f"{name} has no activation {act!r}; it has {tuple(ACTIVATIONS)}")
    if b is not None and (b.shape != a.shape or b.dtype != a.dtype or b.get_device() != a.get_device()):
        raise ValueError(f"{name} takes b like a, {tuple(a.shape)} {a.dtype} on {a.device}, got "
                         f"{tuple(b.shape)} {b.dtype} on {b.device}")
    if a.shape[0] == 0 or a.shape[1] == 0:
        raise ValueError(f"{name} got an empty input: {tuple(a.shape)}")
    if a.is_cuda:
        if a.stride(1) != 1:
            a = a.contiguous()
        if b is not None and b.stride(1) != 1:
            b = b.contiguous()
    return a, b


def act_quantize_rows(a: torch.Tensor, act: str, b: torch.Tensor | None = None,
                      amax: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float32 or bfloat16 rows ``a`` (and ``b`` of the same shape and
    dtype, for SwiGLU and the gated MLP) → the quantized ``act(a)`` or
    ``act(a) * b``, ``act`` one of ``ACTIVATIONS``: (xq (M, K) int8, s_x (M,)
    float32). The plain version on the CPU, ``quantize_rows_s8`` (the
    activation's prologue) on the card, which reads a and b where they lie
    (the two halves of one fc1 output: row-strided views) and never stores
    the activation. With ``amax`` (M,) float32, s_x comes from it."""
    a, b = _check_act("act_quantize_rows", a, act, b)
    _check_amax("act_quantize_rows", amax, a.shape[0], a)
    if a.is_cpu:
        return act_quantize_rows_plain(a, act, b) if amax is None else act_quantize_rows_plain(a, act, b, amax)
    return _launch_quantize(act, a, (0, a.stride(0), a.shape[0], 0, a.shape[1]), b=b, amax=amax)


def act_row_amax(a: torch.Tensor, act: str, b: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The (M,) float32 abs-max of ``act(a)`` or ``act(a) * b``'s rows, as
    ``act_quantize_rows`` computes them, and those rows' values (M, K) in a's
    dtype, which ``quantize_rows(values, amax)`` quantizes to
    ``act_quantize_rows(a, act, b, amax)``'s bytes: the plain version on the
    CPU, ``quantize_rows_s8`` (the activation's prologue, amax-only, storing
    the values) on the card."""
    a, b = _check_act("act_row_amax", a, act, b)
    if a.is_cpu:
        values = _act_rows(a, act, b)
        return row_amax_plain(values), values
    return _launch_quantize(act, a, (0, a.stride(0), a.shape[0], 0, a.shape[1]), b=b, mode="amax_only")


def _launch_quantize(prologue: str, x, layout, rows=None, cols=None, b=None, gamma=None, beta=None, eps=0.0,
                     stats: bool = False, mode: str | None = None, amax=None, body: str | None = None,
                     unit: int | None = None, pitch: int | None = None):
    """Launch ``quantize_rows_s8`` with ``prologue`` over a CUDA operand x
    whose element (m, k) lies at (m / t) sb + (m % t) st + (k / d) sh + k % d
    (``layout`` = (sb, st, t, sh, d); sh = 0: + k), as the public wrappers
    checked it, in ``mode`` (default: given-amax with ``amax``, else
    one-pass) on ``body`` in units of ``unit`` bytes (default: what
    ``quant_variant`` picks; the card tests and the tools force the
    template's modes, or a narrower unit, to hold them against each other):
    (xq, s_x); with ``stats`` (layernorm) also the rows' mean and 1 /
    sqrt(var + eps) as the kernel computed them; amax-only: the (M,) amax,
    and on the streamed body of an activation (amax, the activation's values
    (M, K) in x's dtype). xq is the (M, K) view of an (M, ``pitch``) buffer
    (default ``pitch16(K)``; the card tests pass K, packed rows, to hold the
    two layouts against each other). A row longer than ``QUANT_MAX_K`` is
    refused before any launch; a failed launch raises and nothing runs in
    its place."""
    M = x.shape[0] if rows is None else rows
    K = x.shape[1] if cols is None else cols
    if K > QUANT_MAX_K:
        raise ValueError(f"quantize_rows_s8 holds rows of at most {QUANT_MAX_K} values, got {K}")
    mode = mode or ("one_pass" if amax is None else "given_amax")
    sb, st, t, sh, d = layout
    if mode == "one_pass":  # the one-device path: no alignment to read
        routed, routed_unit = "template", 0
    else:
        routed, routed_unit = quant_variant(mode, prologue, d, x.element_size(), _operand_alignment(x, layout, b))
    if body is None:
        body = routed
    elif body not in QUANT_BODIES:
        raise ValueError(f"quantize_rows_s8 has no body {body!r}; it has {QUANT_BODIES}")
    elif body == "stream" and routed == "template":
        raise ValueError(f"the streamed body takes the amax-only mode of the identity and activation prologues "
                         f"and the identity's given-amax, got {mode} {prologue}")
    store = body == "stream" and mode == "amax_only" and prologue != "identity"
    dev = x.device
    xq = s_x = mean = rstd = values = None
    ldq = pitch16(K) if pitch is None else pitch
    if mode == "amax_only":
        amax = torch.empty(M, dtype=torch.float32, device=dev)
        if store:
            values = torch.empty(M, K, dtype=x.dtype, device=dev)
    else:
        xq = torch.empty(M, ldq, dtype=torch.int8, device=dev)[:, :K]
        s_x = torch.empty(M, dtype=torch.float32, device=dev)
    if amax is not None:
        amax = amax.contiguous()
    if stats:
        mean, rstd = torch.empty(M, dtype=torch.float32, device=dev), torch.empty(M, dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = load_int8_library()
    operands = (PROLOGUES.index(prologue), x.dtype == torch.bfloat16, M, K, x.data_ptr(), sb, st, t, sh, d, ptr(b),
                0 if b is None else b.stride(0))
    if body == "template":
        err = lib.atlas_quantize_rows_s8(*operands, ptr(gamma), ptr(beta), eps, ptr(xq), ldq, ptr(s_x), ptr(mean),
                                         ptr(rstd), QUANT_MODES.index(mode), ptr(amax), _stream(x))
    else:
        err = lib.atlas_quantize_rows_s8_stream(*operands, unit or routed_unit, ptr(xq), ldq, ptr(s_x),
                                                QUANT_MODES.index(mode), ptr(amax), ptr(values), _stream(x))
    if err != 0:
        raise RuntimeError(f"quantize_rows_s8 ({prologue}) launch failed: cudaError {err} ({mode}, {body})")
    quantize_rows.launches += 1
    quantize_rows.prologue_launches[prologue] += 1
    quantize_rows.mode_launches[mode] += 1
    quantize_rows.body_launches[body] += 1
    if mode == "amax_only":
        return (amax, values) if store else amax
    return (xq, s_x, mean, rstd) if stats else (xq, s_x)


def int8_linear(xq, s_x, weight_q, qscale, bias, out_dtype) -> torch.Tensor:
    """(M, K) int8 activations with (M,) float32 scales, (N, K) int8 weights
    with (N,) float32 scales and an (N,) bias (float32, bfloat16 or None) →
    (M, N) ``out_dtype`` (float32 or bfloat16): the plain version on the CPU,
    ``int8_linear_s8`` on the card, the body ``linear_variant`` picks, over
    xq and weight_q where they lie when their rows are (row-pitched views
    included)."""
    _check_2d("xq", xq, torch.int8)
    _check_2d("weight_q", weight_q, torch.int8)
    M, K = xq.shape
    N = weight_q.shape[0]
    if weight_q.shape[1] != K or s_x.shape != (M,) or qscale.shape != (N,):
        raise ValueError(f"int8_linear shapes do not match: xq {tuple(xq.shape)}, s_x {tuple(s_x.shape)}, "
                         f"weight_q {tuple(weight_q.shape)}, qscale {tuple(qscale.shape)}")
    if s_x.dtype != torch.float32 or qscale.dtype != torch.float32:
        raise ValueError(f"int8_linear takes float32 scales, got {s_x.dtype} and {qscale.dtype}")
    if bias is not None and (bias.shape != (N,) or bias.dtype not in _FLOATS):
        raise ValueError(f"int8_linear takes an (N,) float32 or bfloat16 bias, got {bias.dtype} {tuple(bias.shape)}")
    if out_dtype not in _FLOATS:
        raise ValueError(f"int8_linear writes float32 or bfloat16, got {out_dtype}")
    tensors = (xq, s_x, weight_q, qscale) if bias is None else (xq, s_x, weight_q, qscale, bias)
    if all(t.is_cpu for t in tensors):
        return int8_linear_plain(xq, s_x, weight_q, qscale, bias, out_dtype)
    card = xq.get_device()
    if not all(t.is_cuda and t.get_device() == card for t in tensors):
        raise ValueError(f"int8_linear needs its tensors on one device, got {[str(t.device) for t in tensors]}")
    if M == 0 or N == 0 or K == 0:
        raise ValueError(f"int8_linear got an empty product: M {M}, N {N}, K {K}")
    xq, weight_q = _rows_of(xq), _rows_of(weight_q)
    s_x, qscale = s_x.contiguous(), qscale.contiguous()
    bias = None if bias is None else bias.contiguous()
    variant = linear_variant(M, N, K, out_dtype, xq.data_ptr(), weight_q.data_ptr(), _pitch(xq), _pitch(weight_q))
    return _launch_linear(variant, xq, s_x, weight_q, qscale, bias, out_dtype)


def int8_linear_s32(xq: torch.Tensor, weight_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 · (N, K) int8 → the (M, N) int32 product, not
    dequantized: a row-parallel shard's partial. The plain version on the CPU,
    ``int8_linear_s8``'s int32 output on the card, the body ``linear_variant``
    picks (``wgmma`` at every shard of the zoo's TP (1, 2) int8: medsiglip's
    and virchow's fc2, K 2,152 and 1,708, over the row-pitched xq and
    weights the model hands it)."""
    _check_2d("xq", xq, torch.int8)
    _check_2d("weight_q", weight_q, torch.int8)
    M, K = xq.shape
    N = weight_q.shape[0]
    if weight_q.shape[1] != K:
        raise ValueError(f"int8_linear_s32 shapes do not match: xq {tuple(xq.shape)}, weight_q "
                         f"{tuple(weight_q.shape)}")
    if xq.is_cpu and weight_q.is_cpu:
        return int8_linear_s32_plain(xq, weight_q)
    if not (xq.is_cuda and weight_q.device == xq.device):
        raise ValueError(f"int8_linear_s32 needs its tensors on one device, got {xq.device} and {weight_q.device}")
    if M == 0 or N == 0 or K == 0:
        raise ValueError(f"int8_linear_s32 got an empty product: M {M}, N {N}, K {K}")
    xq, weight_q = _rows_of(xq), _rows_of(weight_q)
    variant = linear_variant(M, N, K, torch.int32, xq.data_ptr(), weight_q.data_ptr(), _pitch(xq), _pitch(weight_q))
    return _launch_linear(variant, xq, None, weight_q, None, None, torch.int32)


def dequant_sum(partials, s_x, qscale, bias, out_dtype) -> torch.Tensor:
    """The int32 (M, N) partials of one product whose K was split over
    shards (1 to ``MAX_PARTIALS``, on one device), (M,) float32 row scales,
    (N,) float32 ``qscale`` and an (N,) bias (float32, bfloat16 or None) →
    (M, N) ``out_dtype`` (float32 or bfloat16): their int32 sum, dequantized
    as ``int8_linear`` dequantizes, so equal to it on the whole K. The plain
    version on the CPU, ``dequant_sum_s32`` on the card."""
    partials = list(partials)
    if not 1 <= len(partials) <= MAX_PARTIALS:
        raise ValueError(f"dequant_sum takes 1 to {MAX_PARTIALS} partials, got {len(partials)}")
    first = partials[0]
    _check_2d("a partial", first, torch.int32)
    M, N = first.shape
    if any(p.shape != (M, N) or p.dtype != torch.int32 for p in partials):
        raise ValueError(f"dequant_sum takes int32 partials of one shape, got "
                         f"{[(tuple(p.shape), p.dtype) for p in partials]}")
    if s_x.shape != (M,) or qscale.shape != (N,) or s_x.dtype != torch.float32 or qscale.dtype != torch.float32:
        raise ValueError(f"dequant_sum takes ({M},) and ({N},) float32 scales, got {s_x.dtype} "
                         f"{tuple(s_x.shape)} and {qscale.dtype} {tuple(qscale.shape)}")
    if bias is not None and (bias.shape != (N,) or bias.dtype not in _FLOATS):
        raise ValueError(f"dequant_sum takes an (N,) float32 or bfloat16 bias, got {bias.dtype} {tuple(bias.shape)}")
    if out_dtype not in _FLOATS:
        raise ValueError(f"dequant_sum writes float32 or bfloat16, got {out_dtype}")
    tensors = [*partials, s_x, qscale] + ([] if bias is None else [bias])
    if all(t.is_cpu for t in tensors):
        return dequant_sum_plain(partials, s_x, qscale, bias, out_dtype)
    if not all(t.is_cuda and t.device == first.device for t in tensors):
        raise ValueError(f"dequant_sum needs its tensors on one device, got {[str(t.device) for t in tensors]}")
    if M == 0 or N == 0:
        raise ValueError(f"dequant_sum got an empty output: M {M}, N {N}")
    partials = [p.contiguous() for p in partials]
    s_x, qscale = s_x.contiguous(), qscale.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty(M, N, dtype=out_dtype, device=first.device)
    pointers = (ctypes.c_void_p * len(partials))(*(p.data_ptr() for p in partials))
    err = load_int8_library().atlas_dequant_sum_s32(
        pointers, len(partials), s_x.data_ptr(), qscale.data_ptr(), None if bias is None else bias.data_ptr(),
        int(bias is not None and bias.dtype == torch.bfloat16), out.data_ptr(), int(out_dtype == torch.bfloat16),
        M, N, _stream(first))
    if err != 0:
        raise RuntimeError(f"dequant_sum_s32 launch failed: cudaError {err}")
    dequant_sum.launches += 1
    return out


def _rows_of(t: torch.Tensor) -> torch.Tensor:
    """An (R, K) CUDA operand whose rows the kernels read where they lie
    (unit column stride, rows apart by at least K; row-pitched views
    included), else its contiguous copy."""
    if t.stride(1) == 1 and (t.shape[0] == 1 or t.stride(0) >= t.shape[1]):
        return t
    return t.contiguous()


def _pitch(t: torch.Tensor) -> int:
    """The row pitch in bytes of an int8 operand ``_rows_of`` returned: its
    row stride, or for a single row, whose stride addresses nothing, the
    16-byte pitch of its K."""
    return t.stride(0) if t.shape[0] > 1 else max(t.stride(0), pitch16(t.shape[1]))


def _launch_linear(variant, xq, s_x, weight_q, qscale, bias, out_dtype, block_n=None) -> torch.Tensor:
    """Launch ``variant`` of ``int8_linear_s8`` on CUDA operands
    ``int8_linear`` has checked (xq and weight_q as ``_rows_of`` returns them,
    their pitches read from their strides); the wgmma body in tiles ``block_n`` wide
    (default ``wgmma_block_n``). The card tests and ``chip_smoke.py`` call it
    to hold every body a shape admits against the plain version. A body that
    does not take the shape (``wgmma`` where ``wgmma_admits`` is false) or a
    tile width it has no instantiation of for ``out_dtype`` raises
    ValueError before any launch; a failed encode or launch raises
    RuntimeError and is never retried on the other body. An int32
    ``out_dtype`` is the accumulator itself (s_x, qscale and bias None)."""
    if variant not in LINEAR_VARIANTS:
        raise ValueError(f"int8_linear has no body {variant!r}; it has {LINEAR_VARIANTS}")
    M, K = xq.shape
    N = weight_q.shape[0]
    ldx, ldw = _pitch(xq), _pitch(weight_q)
    if variant == "wgmma":
        if not wgmma_admits(N, K, out_dtype, xq.data_ptr(), weight_q.data_ptr(), ldx, ldw):
            raise ValueError(f"variant 'wgmma' takes row pitches of a multiple of 16 bytes and operands on 16 "
                             f"bytes, and writes bfloat16 with N a multiple of 8 or int32 with N a multiple of 4: "
                             f"got K {K}, row pitches {ldx} and {ldw}, xq at {xq.data_ptr() % 16} and weight_q at "
                             f"{weight_q.data_ptr() % 16} mod 16, N {N}, {out_dtype}")
        if block_n is not None and block_n not in WGMMA_BLOCK_NS:
            raise ValueError(f"the wgmma body's tiles are {WGMMA_BLOCK_NS} wide, got {block_n}")
        sms = _sm_count(xq.get_device())
        if block_n is None:
            block_n = wgmma_block_n(M, N, sms, out_dtype, K)
    out = torch.empty(M, N, dtype=out_dtype, device=xq.device)
    lib = load_int8_library()
    args = (xq.data_ptr(), weight_q.data_ptr(), None if s_x is None else s_x.data_ptr(),
            None if qscale is None else qscale.data_ptr(), None if bias is None else bias.data_ptr(),
            int(bias is not None and bias.dtype == torch.bfloat16), out.data_ptr())
    if variant == "wgmma":
        err = lib.atlas_int8_linear_s8_wgmma(*args, _OUT_CODES[out_dtype], M, N, K, ldx, ldw, block_n, sms,
                                             _stream(xq))
    else:
        err = lib.atlas_int8_linear_s8(*args, _OUT_CODES[out_dtype], M, N, K, ldx, ldw, _stream(xq))
    if err >= _NO_DRIVER_ENTRY:
        raise RuntimeError(f"the CUDA driver has no cuTensorMapEncodeTiled: cudaError {err - _NO_DRIVER_ENTRY}")
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"int8_linear_s8 (wgmma) TMA tensor map encode failed: CUresult {err - _ENCODE_FAILED}")
    if err != 0:
        raise RuntimeError(f"int8_linear_s8 ({variant}) launch failed: cudaError {err}")
    int8_linear.launches += 1
    int8_linear.variant_launches[variant] += 1
    int8_linear.out_launches[str(out_dtype).removeprefix("torch.")] += 1
    return out


quantize_rows.launches = 0
quantize_rows.prologue_launches = Counter()
quantize_rows.mode_launches = Counter()
quantize_rows.body_launches = Counter()
int8_linear.launches = 0
int8_linear.variant_launches = Counter()
int8_linear.out_launches = Counter()
dequant_sum.launches = 0


def reset_launch_counts() -> None:
    """Zero ``quantize_rows.launches``, ``.prologue_launches``,
    ``.mode_launches`` and ``.body_launches``, ``int8_linear.launches``,
    ``.variant_launches`` and ``.out_launches``, and
    ``dequant_sum.launches``."""
    quantize_rows.launches = 0
    quantize_rows.prologue_launches.clear()
    quantize_rows.mode_launches.clear()
    quantize_rows.body_launches.clear()
    int8_linear.launches = 0
    int8_linear.variant_launches.clear()
    int8_linear.out_launches.clear()
    dequant_sum.launches = 0
