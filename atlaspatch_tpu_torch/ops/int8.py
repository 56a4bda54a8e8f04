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
tensor launches the kernel of ``csrc/int8_linear.cu`` (nvcc, sm_90a, built at
first use and loaded with ctypes), which equals the plain version bit for
bit. A build or launch failure on a CUDA tensor raises: nothing falls back to
the plain version or to ``torch._int_mm``. ``quantize_rows.launches`` and
``int8_linear.launches`` count kernel launches; ``reset_launch_counts()``
zeroes both.
"""

from __future__ import annotations

import ctypes
import threading

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


def load_int8_library() -> ctypes.CDLL:
    """Build (once) and load ``csrc/int8_linear.cu``; raises if the build fails."""
    with _LOCK:
        if not _LIB:
            path = build_shared_library("atlas_int8_linear", [CSRC / "int8_linear.cu"],
                                        [nvcc_path(), *_NVCC_FLAGS])
            lib = ctypes.CDLL(str(path))
            lib.atlas_quantize_rows_s8.restype = _INT
            lib.atlas_quantize_rows_s8.argtypes = [_PTR, _INT, _PTR, _PTR, _INT, _INT, _PTR]
            lib.atlas_int8_linear_s8.restype = _INT
            lib.atlas_int8_linear_s8.argtypes = [_PTR] * 5 + [_INT, _PTR] + [_INT] * 4 + [_PTR]
            _LIB.append(lib)
        return _LIB[0]


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
    ``int8_linear_s8`` on the card."""
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
    out = torch.empty(M, N, dtype=out_dtype, device=xq.device)
    err = load_int8_library().atlas_int8_linear_s8(
        xq.data_ptr(), weight_q.data_ptr(), s_x.data_ptr(), qscale.data_ptr(),
        None if bias is None else bias.data_ptr(), int(bias is not None and bias.dtype == torch.bfloat16),
        out.data_ptr(), int(out_dtype == torch.bfloat16), M, N, K, _stream(xq))
    if err != 0:
        raise RuntimeError(f"int8_linear_s8 launch failed: cudaError {err}")
    int8_linear.launches += 1
    return out


quantize_rows.launches = 0
int8_linear.launches = 0


def reset_launch_counts() -> None:
    """Zero ``quantize_rows.launches`` and ``int8_linear.launches``."""
    quantize_rows.launches = 0
    int8_linear.launches = 0
