"""The int8 serving mode's linear: a row quantizer and an int8 tensor-core product.

The two halves of ``atlaspatch_tpu/models/encoders/vit.py::Int8Dense``
(:124-157), which XLA fuses into one program on the TPU:

- ``quantize_rows(x) -> (xq, s_x)``: symmetric dynamic abs-max int8 per row,
  the JAX ``_q8_dyn`` along the last axis (``vit.py:202-206``, inlined in
  ``Int8Dense`` at :143-145);
- ``int8_linear(xq, s_x, weight_q, qscale, bias, out_dtype)``: ``xq @
  weight_q^T`` in int32, then ``float32(acc) * (s_x * qscale)``, then ``+
  bias``, then the cast to ``out_dtype`` (``vit.py:146-156``, in that order).

Each dispatches on the tensor's device: a CPU tensor runs the plain PyTorch
version beside it (``quantize_rows_plain``, ``int8_linear_plain``), a CUDA
tensor launches a kernel of the ``atlas_int8_linear`` library (nvcc, sm_90a,
built at first use and loaded with ctypes), which equals the plain version
bit for bit: ``quantize_rows_s8`` of ``csrc/int8_linear.cu``, and one of
``int8_linear_s8``'s two bodies, picked by ``linear_variant``: ``wgmma``
(``csrc/int8_linear_wgmma.cu``, wgmma s8 fed by TMA, bfloat16 out) or ``mma``
(``csrc/int8_linear.cu``, mma.sync fed by cp.async). A build, tensor-map
encode or launch failure on a CUDA tensor raises: nothing retries on the
other body or falls back to the plain version or to ``torch._int_mm``.
``quantize_rows.launches`` and ``int8_linear.launches`` count kernel
launches, ``int8_linear.variant_launches`` the latter by body;
``reset_launch_counts()`` zeroes all three.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from collections import Counter

import torch

from atlaspatch_tpu_torch.build import CSRC, build_shared_library, nvcc_path

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_FLOATS = (torch.float32, torch.bfloat16)
_LIB: list[ctypes.CDLL] = []
_LOCK = threading.Lock()
# The wgmma body's return codes beyond a cudaError (csrc/int8_linear_wgmma.cu).
_ENCODE_FAILED, _NO_DRIVER_ENTRY = 1_000_000, 2_000_000
LINEAR_VARIANTS = ("wgmma", "mma")
WGMMA_BLOCK_NS = (128, 256)  # the wgmma body's CTA tile widths (its two instantiations)
WGMMA_BLOCK_M = 128


def load_int8_library() -> ctypes.CDLL:
    """Build (once) and load ``csrc/int8_linear.cu`` and
    ``csrc/int8_linear_wgmma.cu`` as one library; raises if the build fails."""
    with _LOCK:
        if not _LIB:
            path = build_shared_library(
                "atlas_int8_linear", [CSRC / "int8_linear.cu", CSRC / "int8_linear_wgmma.cu"],
                [nvcc_path(), *_NVCC_FLAGS])
            lib = ctypes.CDLL(str(path))
            lib.atlas_quantize_rows_s8.restype = _INT
            lib.atlas_quantize_rows_s8.argtypes = [_PTR, _INT, _PTR, _PTR, _INT, _INT, _PTR]
            lib.atlas_int8_linear_s8.restype = _INT
            lib.atlas_int8_linear_s8.argtypes = [_PTR] * 5 + [_INT, _PTR] + [_INT] * 4 + [_PTR]
            lib.atlas_int8_linear_s8_wgmma.restype = _INT
            lib.atlas_int8_linear_s8_wgmma.argtypes = [_PTR] * 5 + [_INT, _PTR] + [_INT] * 5 + [_PTR]
            _LIB.append(lib)
        return _LIB[0]


def wgmma_admits(N: int, K: int, out_dtype: torch.dtype, xq_ptr: int = 0, w_ptr: int = 0) -> bool:
    """Whether the wgmma body takes an (M, K) x (N, K) product to ``out_dtype``
    over operands at these addresses. Its TMA maps want the operands' row
    stride (K bytes) and bases on 16 bytes, and its epilogue stores bfloat16
    rows of 2 N bytes by TMA, so N a multiple of 8."""
    return (out_dtype == torch.bfloat16 and N % 8 == 0 and K % 16 == 0
            and xq_ptr % 16 == 0 and w_ptr % 16 == 0)


def linear_variant(M: int, N: int, K: int, out_dtype: torch.dtype, xq_ptr: int = 0, w_ptr: int = 0) -> str:
    """The body ``int8_linear`` launches for an (M, K) x (N, K) product to
    ``out_dtype`` whose operands start at these addresses: ``wgmma`` where
    ``wgmma_admits`` (every vit_l_16, uni and medsiglip linear of the int8
    engine, which runs bfloat16), else ``mma``: virchow's fc2 (K = 3,416 =
    16 x 213.5), float32 output, N not a multiple of 8. M does not decide:
    at M = 5 the wgmma body is faster than the mma body too (both are bound
    by reading the weights; PERF.md), so small batches stay on it."""
    return "wgmma" if wgmma_admits(N, K, out_dtype, xq_ptr, w_ptr) else "mma"


def wgmma_block_n(M: int, N: int, sms: int = 132) -> int:
    """The wgmma body's CTA tile width for an (M, N) output on a card of
    ``sms`` SMs: 256, whose tiles read less from L2 per product, unless its
    tiles are fewer than the SMs, where 128 doubles the CTAs at work (at M =
    5, medsiglip's MLP runs 1.7-1.9x faster so). Measured on an H100
    (``tools/int8_variants.py``, PERF.md): at vit_l_16's batch-256
    shapes 256 is level with 128 or up to 26% faster, but for qkv (2-4%
    slower); at batch 32 the two are within the run-to-run spread."""
    tiles = -(-M // WGMMA_BLOCK_M) * -(-N // 256)
    return 256 if tiles >= sms else 128


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on every device. (A Python scalar divisor
    of a CUDA tensor becomes a multiply by its reciprocal, which rounds
    otherwise.)"""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def quantize_plain(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric dynamic abs-max int8 along ``dim`` of a float32 tensor, the
    JAX ``_q8_dyn``: (int8 values, float32 scales with ``dim`` kept)."""
    s = _divide(x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8), 127.0)
    return torch.round(x / s).clamp(-127.0, 127.0).to(torch.int8), s


def int_product(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int32 result of ``torch.einsum(equation)`` over int8 operands,
    exact: an int32 product on the CPU; on the card, which has no int32
    product, a float64 one (every partial sum of int8 products is an integer
    far below 2^53) converted back."""
    if a.device.type == "cpu":
        return torch.einsum(equation, a.to(torch.int32), b.to(torch.int32))
    return torch.einsum(equation, a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def quantize_rows_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float32 or bfloat16 → (xq (M, K) int8, s_x (M,) float32)."""
    xq, s = quantize_plain(x.float(), -1)
    return xq, s[:, 0]


def int8_linear_plain(xq, s_x, weight_q, qscale, bias, out_dtype) -> torch.Tensor:
    """(M, K) int8 · (N, K) int8 → (M, N) ``out_dtype``, dequantized by
    float32(acc) * (s_x[m] * qscale[n]) + bias[n]."""
    acc = int_product("mk,nk->mn", xq, weight_q)
    y = acc.float() * (s_x[:, None] * qscale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def _check_2d(name: str, t: torch.Tensor, dtype=None) -> None:
    if t.ndim != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def _stream(t: torch.Tensor) -> int:
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float32 or bfloat16 → (xq (M, K) int8, s_x (M,) float32): the
    plain version on the CPU, ``quantize_rows_s8`` on the card."""
    _check_2d("x", x)
    if x.dtype not in _FLOATS:
        raise ValueError(f"quantize_rows takes float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    if not x.is_cuda:
        raise ValueError(f"quantize_rows takes CPU or CUDA tensors, got {x.device}")
    M, K = x.shape
    if M == 0 or K == 0:
        raise ValueError(f"quantize_rows got an empty input: {tuple(x.shape)}")
    x = x.contiguous()
    xq = torch.empty(M, K, dtype=torch.int8, device=x.device)
    s_x = torch.empty(M, dtype=torch.float32, device=x.device)
    err = load_int8_library().atlas_quantize_rows_s8(
        x.data_ptr(), int(x.dtype == torch.bfloat16), xq.data_ptr(), s_x.data_ptr(), M, K, _stream(x))
    if err != 0:
        raise RuntimeError(f"quantize_rows_s8 launch failed: cudaError {err}")
    quantize_rows.launches += 1
    return xq, s_x


def int8_linear(xq, s_x, weight_q, qscale, bias, out_dtype) -> torch.Tensor:
    """(M, K) int8 activations with (M,) float32 scales, (N, K) int8 weights
    with (N,) float32 scales and an (N,) bias (float32, bfloat16 or None) →
    (M, N) ``out_dtype`` (float32 or bfloat16): the plain version on the CPU,
    ``int8_linear_s8`` on the card, the body ``linear_variant`` picks."""
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
    tensors = [xq, s_x, weight_q, qscale] + ([] if bias is None else [bias])
    if all(t.device.type == "cpu" for t in tensors):
        return int8_linear_plain(xq, s_x, weight_q, qscale, bias, out_dtype)
    if not all(t.is_cuda and t.device == xq.device for t in tensors):
        raise ValueError(f"int8_linear needs its tensors on one device, got {[str(t.device) for t in tensors]}")
    if M == 0 or N == 0 or K == 0:
        raise ValueError(f"int8_linear got an empty product: M {M}, N {N}, K {K}")
    xq, s_x, weight_q, qscale = (t.contiguous() for t in (xq, s_x, weight_q, qscale))
    bias = None if bias is None else bias.contiguous()
    variant = linear_variant(M, N, K, out_dtype, xq.data_ptr(), weight_q.data_ptr())
    return _launch_linear(variant, xq, s_x, weight_q, qscale, bias, out_dtype)


def _launch_linear(variant, xq, s_x, weight_q, qscale, bias, out_dtype, block_n=None) -> torch.Tensor:
    """Launch ``variant`` of ``int8_linear_s8`` on contiguous CUDA operands
    ``int8_linear`` has checked; the wgmma body in tiles ``block_n`` wide
    (default ``wgmma_block_n``). The card tests and ``chip_smoke.py`` call it
    to hold every body a shape admits against the plain version. A body that
    does not take the shape (``wgmma`` where ``wgmma_admits`` is false) or an
    unknown tile width raises ValueError before any launch; a failed encode
    or launch raises RuntimeError and is never retried on the other body."""
    if variant not in LINEAR_VARIANTS:
        raise ValueError(f"int8_linear has no body {variant!r}; it has {LINEAR_VARIANTS}")
    M, K = xq.shape
    N = weight_q.shape[0]
    if variant == "wgmma":
        if not wgmma_admits(N, K, out_dtype, xq.data_ptr(), weight_q.data_ptr()):
            raise ValueError(f"variant 'wgmma' takes K a multiple of 16 and operands on 16 bytes, and writes "
                             f"bfloat16 with N a multiple of 8: got K {K}, xq at {xq.data_ptr() % 16} and weight_q "
                             f"at {weight_q.data_ptr() % 16} mod 16, N {N}, {out_dtype}")
        sms = _sm_count(xq.device.index or 0)
        if block_n is None:
            block_n = wgmma_block_n(M, N, sms)
        if block_n not in WGMMA_BLOCK_NS:
            raise ValueError(f"the wgmma body's tiles are {WGMMA_BLOCK_NS} wide, got {block_n}")
    out = torch.empty(M, N, dtype=out_dtype, device=xq.device)
    lib = load_int8_library()
    args = (xq.data_ptr(), weight_q.data_ptr(), s_x.data_ptr(), qscale.data_ptr(),
            None if bias is None else bias.data_ptr(), int(bias is not None and bias.dtype == torch.bfloat16),
            out.data_ptr())
    if variant == "wgmma":
        err = lib.atlas_int8_linear_s8_wgmma(*args, M, N, K, block_n, sms, _stream(xq))
    else:
        err = lib.atlas_int8_linear_s8(*args, int(out_dtype == torch.bfloat16), M, N, K, _stream(xq))
    if err >= _NO_DRIVER_ENTRY:
        raise RuntimeError(f"the CUDA driver has no cuTensorMapEncodeTiled: cudaError {err - _NO_DRIVER_ENTRY}")
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"int8_linear_s8 (wgmma) TMA tensor map encode failed: CUresult {err - _ENCODE_FAILED}")
    if err != 0:
        raise RuntimeError(f"int8_linear_s8 ({variant}) launch failed: cudaError {err}")
    int8_linear.launches += 1
    int8_linear.variant_launches[variant] += 1
    return out


quantize_rows.launches = 0
int8_linear.launches = 0
int8_linear.variant_launches = Counter()


def reset_launch_counts() -> None:
    """Zero ``quantize_rows.launches``, ``int8_linear.launches`` and
    ``int8_linear.variant_launches``."""
    quantize_rows.launches = 0
    int8_linear.launches = 0
    int8_linear.variant_launches.clear()
