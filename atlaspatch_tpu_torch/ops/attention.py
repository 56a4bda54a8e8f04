"""Attention for the Hiera trunk: a hand-written CUDA kernel and its plain version.

``flash_attention`` launches ``csrc/flash_attn.cu`` (built with nvcc for
sm_90a at first use, loaded with ctypes), the port of the TPU kernel
``atlaspatch_tpu/ops/attention.py::_flash_kernel``. ``reference_attention``
is the plain PyTorch version of the same function. ``attention`` dispatches
on the tensor's device: the plain version for a CPU tensor, the kernel for a
CUDA tensor (or an error). There is no fallback from the kernel to the plain
version and no switch that selects it on the card.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from atlaspatch_tpu_torch.build import CSRC, build_shared_library, nvcc_path

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def load_flash_library() -> ctypes.CDLL:
    """Build (once) and load the kernel library; raises if the build fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = build_shared_library(
            "atlas_flash_attn",
            [CSRC / "flash_attn.cu"],
            [
                nvcc_path(),
                "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v",
            ],
        )
        lib = ctypes.CDLL(str(path))
        lib.atlas_flash_attn_fwd.restype = ctypes.c_int
        lib.atlas_flash_attn_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        _LIB = lib
        return lib


def _strides(t: torch.Tensor) -> list[int]:
    """(B, H, T) element strides of a (B, H, T, D) tensor; 0 for a dim of size 1."""
    return [s if n > 1 else 0 for n, s in zip(t.shape[:3], t.stride()[:3])]


def _kernel_readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it in place (D contiguous, every
    row on 16 bytes), else a contiguous copy."""
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in _strides(t)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float | None = None
) -> torch.Tensor:
    """(B, H, T, D) non-causal attention on the card. T_q and T_kv may differ.

    Takes float32 or bfloat16 CUDA tensors of one dtype with D a multiple of 8
    up to 128; raises on anything else. Reads q, k and v in place where D is
    contiguous and rows are 16-byte aligned (as in views of a fused qkv
    projection), else copies them. Accumulates in float32 and returns the
    input dtype, as a (B, H, T_q, D) view of a (B, T_q, H, D) tensor, so the
    caller's merge of the heads is free. ``flash_attention.launches`` counts
    kernel launches."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected (B, H, T, D) tensors, got {q.shape}, {k.shape}, {v.shape}")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {k.shape}, {v.shape} do not match q {q.shape}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention needs CUDA tensors on one device, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f"flash_attention takes head dims that are multiples of 8 up to 128, got {D}")
    if Tq == 0 or Tk == 0 or B * H == 0:
        raise ValueError(f"flash_attention got an empty sequence: {q.shape}, {k.shape}")
    if sm_scale is None:
        sm_scale = D**-0.5
    q, k, v = _kernel_readable(q), _kernel_readable(k), _kernel_readable(v)
    out = torch.empty(B, Tq, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*_strides(q), *_strides(k), *_strides(v), *_strides(out))
    lib = load_flash_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.atlas_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Tq, Tk, D, strides, _DTYPES[q.dtype], float(sm_scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def reference_attention(q, k, v, sm_scale=None):
    """Plain (B, H, T, D) attention: scores materialised, softmax in float32,
    probabilities cast back to the input dtype before the PV product (as the
    JAX package's reference_attention does)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q * sm_scale, k)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def attention(q, k, v, sm_scale=None):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, sm_scale)
    return flash_attention(q, k, v, sm_scale)
