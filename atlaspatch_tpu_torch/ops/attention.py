"""Attention for the Hiera trunk: hand-written CUDA kernels and their plain version.

``flash_attention`` launches one of the ports of the TPU kernel
``atlaspatch_tpu/ops/attention.py::_flash_kernel``, each built with nvcc for
sm_90a at first use and loaded with ctypes. ``kernel_variant`` picks it:

- ``wgmma_m64`` / ``wgmma_m128`` / ``wgmma_m192``: ``csrc/flash_attn_wgmma.cu``,
  bfloat16 on wgmma fed by TMA, for D in {64, 96, 128} and T_q > 16 (64-,
  128- or 192-row Q tiles: one, two or three consumer warpgroups);
- ``mma``: the bfloat16 body of ``csrc/flash_attn.cu`` on mma.sync, for
  T_q <= 16 and the other head dims;
- ``tf32x3``: the float32 body of ``csrc/flash_attn.cu`` on the tensor cores,
  for D in TF32X3_HEAD_DIMS and T_q > 16: error-compensated 3xTF32 on
  mma.sync (each operand split into a TF32 big and small part, three
  products), which keeps float32 accuracy at the TF32 tensor-core rate. It is
  bound by those operations (3 x 4 T_q T_kv D flop at 495 TFLOP/s) at the
  global blocks, where SDPA's float32 route runs the same scheme;
- ``f32_win``: ``csrc/flash_attn_f32win.cu``, the other float32 windows of up
  to F32WIN_MAX_T query and key rows (the 16/64 and 4/16 q-pool blocks and
  the stage-1 window): each (window, head) whole in shared memory behind a
  cp.async ring of persistent CTAs, one softmax pass in exact float32 FMA;
  bound by bytes;
- ``f32``: the float32 body of ``csrc/flash_attn.cu`` on the CUDA cores (FMA,
  bound by the 67 TFLOP/s FP32 rate), for the rest: longer windows at
  T_q <= 16 or at head dims other than 64 and 96.

``reference_attention`` is the plain PyTorch version of the same function.
``attention`` dispatches on autograd state, then on the tensor's device:

- a call that autograd records (grad mode on and q, k or v requiring a
  gradient) runs ``reference_attention``, on any device, and adds one to
  ``attention.plain_grad_calls``. The kernels are forward-only: their output
  has no ``grad_fn``, and ``flash_attention`` refuses such inputs. The plain
  products are also what the JAX package's train step differentiates, since
  its Pallas kernel has no VJP;
- any other call runs the plain version for a CPU tensor and a kernel for a
  CUDA tensor (or an error).

The choice is made from autograd state before any launch, never from a
failure: a kernel that fails to build or launch raises. There is no switch
that selects the plain version for a forward on the card.
"""

from __future__ import annotations

import collections
import ctypes
import threading

import torch

from atlaspatch_tpu_torch.build import CSRC, build_shared_library, nvcc_path

_LIBS: dict[str, ctypes.CDLL] = {}
_DTYPES = (torch.float32, torch.bfloat16)
_BODIES = {"f32": 0, "mma": 1, "tf32x3": 2}  # flash_attn.cu's body codes
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_int64)
# library name -> (source, entry point, its argument types after the 4 pointers)
_SOURCES = {
    "atlas_flash_attn": (
        "flash_attn.cu", "atlas_flash_attn_fwd",
        [_INT] * 5 + [_STRIDES, _INT, ctypes.c_float, _PTR],
    ),
    "atlas_flash_attn_wgmma": (
        "flash_attn_wgmma.cu", "atlas_flash_attn_wgmma_fwd",
        [_INT] * 5 + [_STRIDES, _INT, ctypes.c_float, _PTR],
    ),
    "atlas_flash_attn_f32win": (
        "flash_attn_f32win.cu", "atlas_flash_attn_f32win_fwd",
        [_INT] * 5 + [_STRIDES, ctypes.c_float, _PTR],
    ),
}
_LOCKS = {name: threading.Lock() for name in _SOURCES}  # one per library: they build in parallel
WGMMA_HEAD_DIMS = (64, 96, 128)
M192_HEAD_DIMS = (64, 96)  # three consumer warpgroups fit their registers without spills
# wgmma variant -> Q rows of its tile (K/V rows 64, 128 and 64: flash_attn_wgmma.cu)
WGMMA_TILES = {"wgmma_m64": 64, "wgmma_m128": 128, "wgmma_m192": 192}
TF32X3_HEAD_DIMS = (64, 96)  # flash_attn.cu builds the tf32x3 body for these (at 128 it spills)
F32WIN_MAX_T = 64  # flash_attn_f32win.cu holds a window of up to 64 query and 64 key rows whole
_VARIANT_DTYPES = {"f32": torch.float32, "tf32x3": torch.float32, "f32_win": torch.float32,
                   "mma": torch.bfloat16,
                   **{name: torch.bfloat16 for name in WGMMA_TILES}}
_ENCODE_FAILED, _NO_DRIVER_ENTRY = 1_000_000, 2_000_000  # flash_attn_wgmma.cu's error bases


def _load(name: str) -> ctypes.CDLL:
    """Build (once) and load one kernel library; raises if the build fails."""
    with _LOCKS[name]:
        if name in _LIBS:
            return _LIBS[name]
        source, entry, argtypes = _SOURCES[name]
        path = build_shared_library(name, [CSRC / source], [nvcc_path(), *_NVCC_FLAGS])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [_PTR] * 4 + argtypes
        _LIBS[name] = lib
        return lib


def load_flash_library() -> ctypes.CDLL:
    """The mma.sync bfloat16 body and the two float32 bodies, ``csrc/flash_attn.cu``."""
    return _load("atlas_flash_attn")


def load_wgmma_library() -> ctypes.CDLL:
    """The wgmma + TMA bfloat16 body, ``csrc/flash_attn_wgmma.cu``."""
    return _load("atlas_flash_attn_wgmma")


def load_f32win_library() -> ctypes.CDLL:
    """The float32 small-window body, ``csrc/flash_attn_f32win.cu``."""
    return _load("atlas_flash_attn_f32win")


def kernel_variant(dtype: torch.dtype, tq: int, tk: int, d: int) -> str:
    """The kernel body ``flash_attention`` launches for these inputs: ``f32``,
    ``f32_win``, ``tf32x3``, ``mma``, ``wgmma_m64``, ``wgmma_m128`` or
    ``wgmma_m192`` (see the module docstring).

    float32 with D in TF32X3_HEAD_DIMS and T_q > 16 takes the 3xTF32 body
    (64-row Q tiles; on the card it is faster than the small-window body at
    the 64/64 and 49/49 windows too); the rest takes the small-window body
    where T_q and T_kv are at most F32WIN_MAX_T (the whole window on chip),
    else the FMA body.

    bfloat16 with D in WGMMA_HEAD_DIMS and T_q > 16 takes the wgmma body: one
    consumer warpgroup (64 Q rows) up to T_q = 64; beyond, three (192 rows)
    where D allows it and the 192-row tiles pad T_q no more than 128-row tiles
    would (the global blocks: 2304 = 12 x 192), else two. T_q <= 16 (the q-pool
    and stage-1 blocks) stays on mma.sync, whose one-warp CTA does not spend a
    64-row wgmma tile on 4 or 16 rows. ``tk`` does not decide for bfloat16."""
    if dtype == torch.float32:
        if d in TF32X3_HEAD_DIMS and tq > 16:
            return "tf32x3"
        return "f32_win" if tq <= F32WIN_MAX_T and tk <= F32WIN_MAX_T else "f32"
    if d not in WGMMA_HEAD_DIMS or tq <= 16:
        return "mma"
    if tq <= 64:
        return "wgmma_m64"
    if d in M192_HEAD_DIMS and -tq % 192 <= -tq % 128:
        return "wgmma_m192"
    return "wgmma_m128"


def _strides(t: torch.Tensor) -> list[int]:
    """(B, H, T) element strides of a (B, H, T, D) tensor; 0 for a dim of size 1."""
    return [s if n > 1 else 0 for n, s in zip(t.shape[:3], t.stride()[:3])]


def _tma_strides(t: torch.Tensor) -> list[int]:
    """(B, H, T) element strides of a (B, H, T, D) tensor as a TMA map takes
    them: a dimension of size 1, never stepped, gets the contiguous stride in
    place of whatever torch keeps for it (the map wants multiples of 16
    bytes)."""
    B, H, T, D = t.shape
    s_b, s_h, s_t = t.stride()[:3]
    s_t = s_t if T > 1 else D
    s_h = s_h if H > 1 else s_t * T
    s_b = s_b if B > 1 else s_h * H
    return [s_b, s_h, s_t]


def _kernel_readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when every body can read it in place (D contiguous, every
    row on 16 bytes, no broadcast dimension: a TMA map takes no zero stride),
    else a contiguous copy."""
    rows_ok = all(s % 8 == 0 and (s or n == 1) for n, s in zip(t.shape[:3], t.stride()[:3]))
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and rows_ok:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """(B, H, T, D) non-causal attention on the card. T_q and T_kv may differ.

    Takes float32 or bfloat16 CUDA tensors of one dtype with D a multiple of 8
    up to 128; raises on anything else. Reads q, k and v in place where D is
    contiguous and rows are 16-byte aligned (as in views of a fused qkv
    projection), else copies them. Accumulates in float32 and returns the
    input dtype, as a (B, H, T_q, D) view of a (B, T_q, H, D) tensor, so the
    caller's merge of the heads is free. Launches the body ``kernel_variant``
    picks; ``flash_attention.launches`` counts kernel launches, and
    ``flash_attention.variant_launches`` counts them by variant. Refuses
    inputs that require a gradient while grad mode is on: the output has no
    ``grad_fn``, so a backward pass would get no gradient through it."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected (B, H, T, D) tensors, got {q.shape}, {k.shape}, {v.shape}")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {k.shape}, {v.shape} do not match q {q.shape}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention needs CUDA tensors on one device, got {q.device}")
    if _records_grad(q, k, v):
        raise ValueError(
            "flash_attention is forward-only and its output carries no gradient, but an input "
            "requires one; differentiate reference_attention (attention() routes such calls)"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f"flash_attention takes head dims that are multiples of 8 up to 128, got {D}")
    if Tq == 0 or Tk == 0 or B * H == 0:
        raise ValueError(f"flash_attention got an empty sequence: {q.shape}, {k.shape}")
    return _launch(kernel_variant(q.dtype, Tq, Tk, D), q, k, v, sm_scale)


def _launch(variant: str, q, k, v, sm_scale: float | None = None) -> torch.Tensor:
    """Launch ``variant`` on inputs ``flash_attention`` has checked. The card
    tests call it to hold every body a shape fits against the plain version;
    a wgmma tile or a tf32x3 body the library does not build for this D
    raises, as does f32_win past F32WIN_MAX_T."""
    if _VARIANT_DTYPES.get(variant) != q.dtype:
        raise ValueError(f"variant {variant!r} does not take {q.dtype}")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if variant == "f32_win" and max(Tq, Tk) > F32WIN_MAX_T:
        raise ValueError(f"variant 'f32_win' takes T_q and T_kv up to {F32WIN_MAX_T}, got {Tq}, {Tk}")
    if sm_scale is None:
        sm_scale = D**-0.5
    q, k, v = _kernel_readable(q), _kernel_readable(k), _kernel_readable(v)
    out = torch.empty(B, Tq, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    operand_strides = _tma_strides if variant in WGMMA_TILES else _strides
    strides = (ctypes.c_int64 * 12)(
        *operand_strides(q), *operand_strides(k), *operand_strides(v), *_strides(out)
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if variant in WGMMA_TILES:
        err = load_wgmma_library().atlas_flash_attn_wgmma_fwd(
            *ptrs, B, H, Tq, Tk, D, strides, WGMMA_TILES[variant], float(sm_scale), stream
        )
    elif variant == "f32_win":
        err = load_f32win_library().atlas_flash_attn_f32win_fwd(
            *ptrs, B, H, Tq, Tk, D, strides, float(sm_scale), stream
        )
    else:
        err = load_flash_library().atlas_flash_attn_fwd(
            *ptrs, B, H, Tq, Tk, D, strides, _BODIES[variant], float(sm_scale), stream
        )
    if err >= _NO_DRIVER_ENTRY:
        raise RuntimeError(
            f"the CUDA driver has no cuTensorMapEncodeTiled: cudaError {err - _NO_DRIVER_ENTRY}"
        )
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"TMA tensor map encode failed ({variant}): CUresult {err - _ENCODE_FAILED}")
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed ({variant}): cudaError {err}")
    flash_attention.launches += 1
    flash_attention.variant_launches[variant] += 1
    return out


flash_attention.launches = 0
flash_attention.variant_launches = collections.Counter()


def reset_launch_counts() -> None:
    """Zero ``flash_attention.launches``, its per-variant counts and
    ``attention.plain_grad_calls``."""
    flash_attention.launches = 0
    flash_attention.variant_launches.clear()
    attention.plain_grad_calls = 0


def _records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def reference_attention(q, k, v, sm_scale=None):
    """Plain (B, H, T, D) attention: scores materialised, softmax in float32,
    probabilities cast back to the input dtype before the PV product (as the
    JAX package's reference_attention does)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q * sm_scale, k)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def bf16_error_limit(q, k, v, sm_scale=None):
    """The plain version in float32 of bfloat16 (q, k, v), and the most a
    bfloat16 body may differ from it, element by element.

    A body rounds each probability p to bfloat16 before the PV product, and
    its float32 result to bfloat16, each within u = 2^-8 of its value; all else
    is float32. So |body - plain| <= u * (sum_j p_j |v_j| + |plain|) for each
    output element; 5% on top covers float32 sums taken in another order and
    ex2.approx. Returns (plain, limit), both float32."""
    q, k, v = q.float(), k.float(), v.float()
    want = reference_attention(q, k, v, sm_scale)
    spread = reference_attention(q, k, v.abs(), sm_scale)
    return want, 1.05 * 2.0**-8 * (spread + want.abs())


def f32_error_limit(q, k, v, sm_scale=None):
    """The plain version in float32 of (q, k, v), and the most a float32 body
    may differ from it, element by element.

    The tf32x3 body splits every operand x into big = tf32(x) and small =
    tf32(x - big), both rounded to nearest, and drops small * small: each
    product is within 3 * 2^-22 of its value, and u = 2^-20 covers that. A
    score s_j is then off by at most u * a_j, a_j = |scale| sum_d |q_d k_jd|,
    which moves the output by sum_j p_j u a_j |v_j - out| <= u * (sum_j p_j a_j
    |v_j| + |out| sum_j p_j a_j); the PV product and the final division add
    u * (sum_j p_j |v_j| + |out|). The float32 sums' own rounding stays far
    inside this worst-case weighting: the body emulated in float64 reads at
    most 0.072 of the limit and one uncompensated TF32 pass 12x or more
    (tests/test_torch_attention_dispatch.py); on an H100, whose tensor cores
    truncate their sums, the body reads at most 0.30 and that fault 14.8x
    at the global block. The FMA and small-window bodies round only in
    float32, so they are held to the same limit. Returns (plain, limit),
    both float32."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    q, k, v = q.float(), k.float(), v.float()
    want = reference_attention(q, k, v, sm_scale)
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q * sm_scale, k), dim=-1)
    pa = p * torch.einsum("bhqd,bhkd->bhqk", q.abs(), k.abs()) * abs(sm_scale)
    spread = torch.einsum("bhqk,bhkd->bhqd", pa, v.abs()) + pa.sum(-1, keepdim=True) * want.abs()
    del pa
    spread += torch.einsum("bhqk,bhkd->bhqd", p, v.abs()) + want.abs()
    return want, 2.0**-20 * spread


def attention(q, k, v, sm_scale=None):
    """The plain version where autograd records the call (counted in
    ``attention.plain_grad_calls``) or the tensors are on the CPU or the meta
    device (shapes only, as a FLOP count runs them); else the CUDA kernel."""
    if _records_grad(q, k, v):
        attention.plain_grad_calls += 1
        return reference_attention(q, k, v, sm_scale)
    if q.device.type in ("cpu", "meta"):
        return reference_attention(q, k, v, sm_scale)
    return flash_attention(q, k, v, sm_scale)


attention.plain_grad_calls = 0
